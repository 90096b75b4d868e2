#!/usr/bin/env python3
"""K2's two row chains by batch on one NVIDIA GPU, for choosing the batch up
to which the wrapper takes the clustered one (``ops/mlp_kernel.py``:
``CLUSTER_MAX_ROWS``, ``NAIS_CLUSTER_MAX_ROWS``):

    python3 scripts/k2_crossover.py [--nais] [--tree TREE] B [B ...]

At full width, [101, 256 x 4, 1] (the FC-Sine MLP, or with ``--nais`` the
NAIS-Net Sine in the kernels' layout, both with weights from seed 0), it
times K2 through each of its C entry points, the one-block row chain and the
clustered one, each with the weight-gradient kernel: CUDA events around 10
replays of a captured graph of 20 calls (device time, without the
wrapper's host work), in turns (one-block, clustered, clustered,
one-block), and prints the mean us a call of each, the chain the wrapper
takes at that B, the card's name and power limit, and last one JSON line.
``--tree`` imports the package of another checkout (say a ``git archive`` of
the parent unpacked under ``build/``); a tree without the NAIS-Net's
clustered chain times its one-block chain only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
LAYERS = [101, 256, 256, 256, 256, 1]


def weights(device, nais: bool):
    import torch

    gen = torch.Generator().manual_seed(0)
    if nais:
        from dnnpde_tpu_torch.nets.networks import build_network
        from dnnpde_tpu_torch.params import extract_nais_params

        net = build_network("Naisnet", LAYERS, "Sine", generator=gen, device=device)
        with torch.no_grad():
            Ws, bs = extract_nais_params(net)
        return [w.detach().contiguous() for w in Ws], [b.detach().contiguous() for b in bs]
    Ws = [(torch.randn((a, b), generator=gen) / a ** 0.5).to(device)
          for a, b in zip(LAYERS[:-1], LAYERS[1:])]
    bs = [(0.1 * torch.randn((b,), generator=gen)).to(device) for b in LAYERS[1:]]
    return Ws, bs


def time_us(fn, calls: int = 20, replays: int = 10) -> float:
    """Device us a call of fn: CUDA events around replays of one captured
    graph of ``calls`` calls, so the wrapper's host work is not timed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # builds, the allocator's blocks
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1000.0 * start.elapsed_time(end) / (calls * replays)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", type=int, nargs="+")
    ap.add_argument("--nais", action="store_true")
    ap.add_argument("--tree", type=Path, default=HERE)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    from dnnpde_tpu_torch.ops import mlp_kernel as mk

    device = torch.device("cuda", torch.cuda.current_device())
    Ws, bs = weights(device, args.nais)
    widths = mk.check_mlp(Ws, bs, device, nais=args.nais)
    base = "mlp_u_z_bwd_nais" if args.nais else "mlp_u_z_bwd"
    lib = mk._lib("mlp_u_z_bwd")
    entries = [base] + ([f"{base}_cluster"] if hasattr(lib, f"{base}_cluster") else [])
    rows = {}
    for B in args.batches:
        gen = torch.Generator().manual_seed(B)
        x, u_bar, z_bar = (torch.randn(s, generator=gen).to(device)
                           for s in ((B, LAYERS[0]), (B, 1), (B, LAYERS[0])))
        us = {e: [] for e in entries}
        for e in entries + entries[::-1]:
            us[e].append(time_us(lambda: mk._bwd_launch(e, Ws, bs, x, u_bar, z_bar, widths)))
        takes = mk.bwd_takes_cluster(widths, B, nais=args.nais) if args.nais else \
            mk.bwd_takes_cluster(widths, B)
        rows[B] = {e: sum(v) / len(v) for e, v in us.items()} | {"wrapper_takes_cluster": takes}
        print(f"B={B}: " + ", ".join(f"{e} {t:.1f} us" for e, t in rows[B].items()
                                       if e != "wrapper_takes_cluster")
              + f"; the wrapper takes the {'clustered' if takes else 'one-block'} chain")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(json.dumps({"tree": str(args.tree), "nais": args.nais, "card": card, "us": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
