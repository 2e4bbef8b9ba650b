"""Batch server for E4T sampling: ``python -m e4t_diffusion_torch.serve_e4t``.

Counterpart of the JAX package's ``scripts/serve_e4t.py``. It loads the
artifact directory once (``inference.build_pipeline``), validates every
prompt before the first render, then renders a prompts file in fixed-size
batches of distinct prompts (the pipeline batches per-sample prompt
embeddings); the last batch is padded to the same size with its last
prompt and the extra images dropped. It writes ``<index>.png`` and
``manifest.jsonl`` (prompt, file, the batch's wall seconds) to
``--output_dir`` and prints one final JSON line: steady-state images/s over
every batch but the first, which absorbs the one-time int8 calibrations
and is reported apart. It takes the inference CLI's serving flags
(``--scheduler_type``, ``--int8*``, ``--act_scales``, ``--lora_*``,
``--dtype``, ``--device``, ``--tensor_parallel``,
``--data_parallel_serving``; ``inference.add_serving_args``). Under
torchrun every rank renders each batch (its rows with
``--data_parallel_serving``) and rank 0 writes the files and the record.

    python -m e4t_diffusion_torch.serve_e4t \\
        --pretrained_model_name_or_path DIR --image_path IMG \\
        --prompts_file prompts.txt --batch_size 8 --output_dir out \\
        [--int8 --int8_static_act --int8_aux_static] [--device cpu]

prompts.txt: one prompt per line, each with the placeholder token (e.g.
"*s"); blank lines and '#' comments are skipped. ``--interactive`` reads
prompts from standard input instead, one render each at batch 1, and
writes ``interactive-<i>.png``. Under torchrun rank 0 alone reads standard
input and hands each line to every rank (over a gloo group of their own, in
which the others wait for a person's next line as long as it takes, and
not the world group, whose timeout would abort them); every rank renders
it with the
same seed (under ``--data_parallel_serving`` the prompt repeated dp times,
so the batch divides, and the first image kept, as the JAX server does),
a prompt without the placeholder is refused on every rank alike, and
rank 0 writes the image:

    echo "a photo of *s" | torchrun --nproc_per_node 2 \
        -m e4t_diffusion_torch.serve_e4t --interactive \
        --pretrained_model_name_or_path DIR --image_path IMG \
        --tensor_parallel 2
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from e4t_diffusion_torch import inference
from e4t_diffusion_torch.utils.image import load_image


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    inference.add_serving_args(parser)
    parser.add_argument("--image_path", type=str, required=True,
                        help="the personalization input image")
    parser.add_argument("--prompts_file", type=str, default=None)
    parser.add_argument("--interactive", action="store_true",
                        help="read prompts from standard input, one render "
                             "each")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="distinct prompts per sampling run")
    parser.add_argument("--num_inference_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--height", type=int, default=None,
                        help="default: the base UNet's sample_size x 8 "
                             "(512 for SD v1, 768 for SD 2.1)")
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_dir", type=str, default="served")
    return parser.parse_args(argv)


def read_prompts(path: str):
    with open(path, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f]
    return [ln for ln in lines if ln and not ln.startswith("#")]


def interactive_prompts(mesh, stream=None):
    """The non-blank lines of ``stream`` (standard input), stripped, on
    every rank: rank 0 alone reads, and each line, then ``None`` at the end
    of input, is broadcast to every rank, so every rank leaves the loop at
    the same line. The broadcast goes over ``mesh.patient_group()``: the
    other ranks wait there while rank 0 waits on a person, for as long as
    it takes, where the world group's timeout would abort them."""
    stream = sys.stdin if stream is None else stream
    group = mesh.patient_group()
    while True:
        prompt = None
        if mesh.is_main:
            for line in iter(stream.readline, ""):
                if line.strip():
                    prompt = line.strip()
                    break
        prompt = mesh.broadcast_object(prompt, group)
        if prompt is None:
            return
        yield prompt


def main(argv=None):
    """Serve as the flags say. Returns the pipeline and the final record
    (None in interactive mode), for callers that drive the server in
    process."""
    args = parse_args(argv)
    if not (args.interactive or args.prompts_file):
        sys.exit("--prompts_file or --interactive is required")
    prompts = [] if args.interactive else read_prompts(args.prompts_file)
    if not (args.interactive or prompts):
        sys.exit(f"no prompts in {args.prompts_file}")
    pipe = inference.build_pipeline(args)
    is_main = pipe.mesh.is_main
    image = load_image(args.image_path)
    os.makedirs(args.output_dir, exist_ok=True)

    def render(batch, seed):
        t0 = time.perf_counter()
        images = pipe(batch if len(batch) > 1 else batch[0], image,
                      num_inference_steps=args.num_inference_steps,
                      guidance_scale=args.guidance_scale,
                      height=args.height, width=args.width, seed=seed,
                      output_type="pil")
        wall = time.perf_counter() - t0  # PIL output: the work is done
        inference.maybe_save_act_scales(pipe, args)
        return images, wall

    if args.interactive:
        # under data-parallel serving the batch must divide by dp: the
        # prompt is repeated over dp and the first image kept
        n_rep = pipe.mesh.dp if args.data_parallel_serving else 1
        if is_main:
            print("interactive mode: one prompt per line (Ctrl-D to exit)",
                  flush=True)
        idx = 0
        for prompt in interactive_prompts(pipe.mesh):
            try:
                # every rank holds the same prompt, so every rank refuses
                # it alike, before any collective
                pipe._prepare_prompt(prompt)
                images, wall = render([prompt] * n_rep, args.seed + idx)
            except ValueError as e:  # e.g. no placeholder token
                if is_main:
                    print(f"error: {e}", flush=True)
                continue
            if is_main:
                path = os.path.join(args.output_dir,
                                    f"interactive-{idx}.png")
                images[0].save(path)
                print(f"{path}  ({wall:.2f}s)", flush=True)
            idx += 1
        pipe.mesh.barrier()
        return pipe, None

    bad = []
    for i, p in enumerate(prompts):
        try:
            pipe._prepare_prompt(p)
        except ValueError as e:
            bad.append(f"  prompt {i}: {p!r} ({e})")
    if bad:
        sys.exit("invalid prompts (fix before serving):\n" + "\n".join(bad))
    bs = max(1, args.batch_size)
    walls = []
    with open(os.path.join(args.output_dir, "manifest.jsonl") if is_main
              else os.devnull, "w", encoding="utf-8") as manifest:
        for start in range(0, len(prompts), bs):
            chunk = prompts[start:start + bs]
            padded = chunk + [chunk[-1]] * (bs - len(chunk))
            images, wall = render(padded, args.seed + start)
            walls.append(wall)
            if not is_main:
                continue
            for i, (prompt, img) in enumerate(zip(chunk, images)):
                path = os.path.join(args.output_dir, f"{start + i:05d}.png")
                img.save(path)
                manifest.write(json.dumps(
                    {"prompt": prompt, "file": path, "batch_wall_s": wall,
                     "warmup_batch": start == 0}) + "\n")
            print(f"[serve] {start + len(chunk)}/{len(prompts)} "
                  f"({len(chunk)}/{len(padded)} kept, {wall:.3f}s batch)",
                  file=sys.stderr)
    steady = len(prompts) - min(bs, len(prompts))
    if steady:
        value = steady / sum(walls[1:])
        note = "steady state: the first batch (calibration) excluded"
    else:
        value = len(prompts) / walls[0]
        note = "one batch, calibration included"
    record = {"metric": "e4t_serve_images_per_sec", "value": value,
              "unit": "images/sec", "images": len(prompts),
              "batch_size": bs, "first_batch_wall_s": walls[0],
              "steady_wall_s": sum(walls[1:]), "batch_walls_s": walls,
              "note": note}
    if is_main:
        print(json.dumps(record))
    pipe.mesh.barrier()
    return pipe, record


if __name__ == "__main__":
    main()
