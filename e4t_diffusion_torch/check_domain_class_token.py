"""Check that the domain class token encodes to exactly one CLIP token.

Counterpart of ``scripts/check_domain_class_token.py``, on the port's
tokenizer: the same usage, the same output and the same exit code. A
local tokenizer directory (``vocab.json``, ``merges.txt``), no hub id.

    python -m e4t_diffusion_torch.check_domain_class_token \
        <token> <tokenizer_dir>

Prints ``ok: '<token>' -> token id <id>`` and exits 0 for a one-token word;
a word of several tokens exits 1 with the count on standard error.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

from e4t_diffusion_torch.utils.tokenizer import CLIPTokenizer

USAGE = ("usage: python -m e4t_diffusion_torch.check_domain_class_token "
         "<token> <tokenizer_dir>")


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 2:
        sys.exit(USAGE)
    domain_class_token, tokenizer_dir = argv[0], argv[1]
    tokenizer = CLIPTokenizer.from_pretrained(tokenizer_dir)
    token_id = tokenizer(domain_class_token, add_special_tokens=False,
                         padding=None)["input_ids"][0]
    if len(token_id) != 1:
        sys.exit(f"AssertionError: {domain_class_token!r} is "
                 f"{len(token_id)} tokens; choose a single-token class word")
    print(f"ok: {domain_class_token!r} -> token id {token_id[0]}")
    return 0


if __name__ == "__main__":
    main()
