"""What the drivers share: seeded weights, the port's problem and net, the
comparisons."""

from __future__ import annotations

import statistics

import torch

from benchmark.core.spec import sub_seed

Tensor = torch.Tensor
BIAS_SCALE = 0.1


def weights(layers, seed: int, device) -> tuple[list[Tensor], list[Tensor]]:
    """Xavier-uniform weights W_k (in, out) and biases U(−0.1, 0.1), f32, drawn
    on ``device`` from ``seed`` in one call."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    sizes = [a * b for a, b in zip(layers[:-1], layers[1:])] + list(layers[1:])
    u = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    parts = u.split(sizes)
    L = len(layers) - 1
    Ws = [(parts[k] * (6.0 / (layers[k] + layers[k + 1])) ** 0.5).reshape(layers[k], layers[k + 1])
          for k in range(L)]
    bs = [parts[L + k] * BIAS_SCALE for k in range(L)]
    return Ws, bs


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def port_problem(cfg: dict):
    """The port's PDE named by the configuration."""
    import dnnpde_tpu_torch.pde as pde

    p = cfg["problem"]
    return getattr(pde, p["class"])(**p.get("args", {}))


def load_mlp(net, Ws, bs) -> None:
    """Copy (Ws, bs) into a port ``MLP``'s parameters, in place."""
    with torch.no_grad():
        for layer, W, b in zip(net.dense, Ws, bs, strict=True):
            layer.linear.weight.copy_(W.T)
            layer.linear.bias.copy_(b)


def rel_max_gap(program: list[Tensor], reference: list[Tensor]) -> float:
    """max |program − reference| over max |reference|, over all the pairs."""
    err = max(float((p.to(r.device) - r).abs().max()) for p, r in zip(program, reference))
    scale = max(float(r.abs().max()) for r in reference)
    return err / scale


def leaf_norm_gap(program: list[Tensor], reference: list[Tensor], rule: list[Tensor]) -> float:
    """The worst leaf's |‖program‖ − ‖reference‖|, over the larger of that
    leaf's ‖reference‖ and the median leaf's. Leaves whose ``rule`` norm (the
    reference's first gradient) is under a thousandth of the median leaf's
    are left out: they move by round-off alone."""
    rule_norms = [float(torch.linalg.vector_norm(g)) for g in rule]
    floor = 1e-3 * statistics.median(rule_norms)
    pairs = [(float(torch.linalg.vector_norm(p)), float(torch.linalg.vector_norm(r)))
             for p, r, n in zip(program, reference, rule_norms, strict=True) if n >= floor]
    median = statistics.median(r for _, r in pairs)
    return max(abs(p - r) / max(r, median) for p, r in pairs)
