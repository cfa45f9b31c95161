"""How far serving under the model-axis layout moves a model's logits in
bf16, beside how far bf16 moves the unsharded model's own: on the CPU, a
spawned gloo world of ``--tp`` ranks serves the model's share
(``convert.serve_slice`` under ``sharding_ctx.serve_region``) from the
same bf16 weights as the unsharded steps, which also run with an f32
compute dtype (the weights widened exactly).  Prints the relative L2 gap
of each step's logits (the prefill's last token, then the decode steps):
tp against the unsharded bf16 steps, the unsharded bf16 steps against
the f32 ones, and tp against the f32 ones.

    PYTHONPATH=src python scripts/serve_tp_bf16_gap.py --arch xlstm-125m \\
        --layers 12 --prompt 128 --steps 2

Random weights (seed 0) at full width; ``--layers`` cuts the depth.  Host
memory: the unsharded model twice and each rank's share.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch


def _cfg(args, dtype: str):
    from repro_torch.configs import get_config
    over = {"param_dtype": "bfloat16", "compute_dtype": dtype}
    if args.layers:
        over["num_layers"] = args.layers
    return dataclasses.replace(get_config(args.arch), **over)


def _steps(args, cfg, params):
    """(prefill logits, step logits...) stacked, f32, on the host."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import Model
    model = Model(cfg)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (args.batch, args.prompt)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (args.steps, args.batch, 1)))
    max_len = args.prompt + args.steps
    out = []
    with torch.no_grad():
        logits, cache = make_prefill_step(model, max_len)(
            params, {"tokens": tokens})
        out.append(logits.float())
        step = make_decode_step(model, donate=True)
        for i in range(args.steps):
            logits, cache = step(params, forced[i], cache, args.prompt + i)
            out.append(logits.float())
    return torch.stack(out)


def _rank(rank: int, world: int, store: str, args, out_dir: str) -> None:
    import torch.distributed as dist
    from repro_torch.convert import serve_slice
    from repro_torch.launch.dist import init_group
    from repro_torch.models.sharding_ctx import serve_region
    torch.set_num_threads(args.threads)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    cfg = _cfg(args, "bfloat16")
    full = torch.load(os.path.join(out_dir, "params.pt"))
    params = serve_slice(full, cfg, rank, world)
    del full
    with serve_region(dist.group.WORLD, (), args.prompt + args.steps):
        got = _steps(args, cfg, params)
    if rank == 0:
        torch.save(got, os.path.join(out_dir, "tp.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _gaps(a, b):
    n = a.shape[0]
    return [float(x) for x in (a - b).reshape(n, -1).norm(dim=1)
            / b.reshape(n, -1).norm(dim=1)]


def main(argv=None) -> None:
    from repro_torch._tree import tree_map
    from repro_torch.launch.dist import spawn
    from repro_torch.models.model import Model
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args(argv)
    cfg = _cfg(args, "bfloat16")
    params = Model(cfg).init(torch.Generator().manual_seed(0),
                             device="cpu")
    out_dir = tempfile.mkdtemp(prefix="serve_tp_bf16_gap_")
    torch.save(params, os.path.join(out_dir, "params.pt"))
    bf16 = _steps(args, cfg, params)
    f32 = _steps(args, _cfg(args, "float32"),
                 tree_map(lambda t: t.float(), params))
    del params
    spawn(_rank, args.tp, args=(args, out_dir), timeout=3600)
    tp = torch.load(os.path.join(out_dir, "tp.pt"))
    print(f"{args.arch} ({cfg.num_layers} layers), B={args.batch}, prompt "
          f"{args.prompt}, {args.steps} steps, tp={args.tp}; relative L2 "
          f"gap of the logits a step:")
    print(f"  tp bf16 vs unsharded bf16:  {_gaps(tp, bf16)}")
    print(f"  unsharded bf16 vs f32:      {_gaps(bf16, f32)}")
    print(f"  tp bf16 vs unsharded f32:   {_gaps(tp, f32)}")


if __name__ == "__main__":
    main()
