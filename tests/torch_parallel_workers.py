"""Rank programs of the port's parallel tests, on gloo ranks on the CPU.

``run_job(name, nprocs, tmp_path)`` starts ``nprocs`` ranks of this file
through the port's launcher (rendezvous over a file store in ``tmp_path``,
one intra-op thread a rank); each rank joins the group, runs the job
``name`` and saves what it found to ``tmp_path/name.<rank>.pt``, which
``run_job`` returns, one dict per rank. Inputs go the other way through
``tmp_path/inputs.pt``. This module imports torch and the port only, so the
ranks never load JAX; the tests compute the JAX side in their own process.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # run as a script, the ranks import the port from the checkout
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dnnpde_tpu_torch import parallel  # noqa: E402
from dnnpde_tpu_torch.parallel import distributed as pdist  # noqa: E402
from dnnpde_tpu_torch.parallel import model_sharding  # noqa: E402
from dnnpde_tpu_torch.pde import (  # noqa: E402
    AmericanPutOption,
    BermudanMaxCall,
    BlackScholesBarenblatt,
    HestonAmericanPut,
    HestonPDE,
    UpAndOutCall,
)
from dnnpde_tpu_torch.sim import lognormal_x0  # noqa: E402
from dnnpde_tpu_torch.train import Trainer  # noqa: E402

JOBS = {}
CPU = "cpu"


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def run_job(name: str, nprocs: int, tmp_path: Path, timeout_s: float = 240.0) -> list[dict]:
    """Run job ``name`` on ``nprocs`` gloo ranks; each rank's saved dict."""
    store = tmp_path / f"{name}.store"
    pdist.launch(nprocs, [sys.executable, str(Path(__file__)), name, str(tmp_path)],
                 store=str(store), timeout_s=timeout_s)
    return [torch.load(tmp_path / f"{name}.{r}.pt", weights_only=False) for r in range(nprocs)]


def _final(tr: Trainer, steps: int = 2) -> tuple[float, float]:
    res = tr.train(steps, 1e-3, "Adam", log_every=steps, verbose=False)
    return float(res.graph[1][-1]), float(res.y0_history[-1])


def local_state(tr: Trainer) -> dict:
    """This rank's tensors: parameters, Adam's moments and the EMA."""
    out = {"params": [p.detach().clone() for p in tr._params]}
    for k in ("mu", "nu"):
        out[k] = [x.clone() for x in tr._opt_state[k]]
    if tr._ema is not None:
        out["ema"] = [e.detach().clone() for e in tr._ema.parameters()]
    return out


DP_TP_LAYERS = [9, 512, 512, 1]  # the 2-D config's net, wide enough that "tp" shards


def dryrun_configs(bsb):
    """``__graft_entry__._dryrun_body``'s data-parallel configs: name ->
    (problem, layers, Trainer keywords). ``chip_smoke.py`` runs them on the
    card from this table."""
    local_ema = dict(objective="local", ema_decay=0.999)
    return {
        "bsb": (bsb, [9, 32, 32, 32, 32, 1], {}),
        "bf16_ema_antithetic": (bsb, [9, 32, 32, 32, 32, 1], dict(
            net_kwargs={"compute_dtype": "bfloat16"}, ema_decay=0.99, antithetic=True)),
        "heston_full_sigma_correlated": (HestonPDE(clamp_output=True), [3, 16, 16, 1],
                                         dict(correlation_type="random_correlation")),
        "heston_bs_local_ema_antithetic": (
            HestonPDE(clamp_output=True, clamp_smoothing="bs"), [3, 16, 16, 1],
            dict(local_ema, antithetic=True)),
        "american_put": (AmericanPutOption(), [2, 16, 16, 1], local_ema),
        "heston_american_put": (HestonAmericanPut(), [3, 16, 16, 1], local_ema),
        "bermudan_max_call": (BermudanMaxCall(D=2, N_steps=4, n_exercise=2), [3, 16, 16, 1],
                              local_ema),
        "barrier": (UpAndOutCall(), [3, 16, 16, 1], dict(objective="local")),
        "sampled_x0": (bsb, [9, 16, 16, 1], dict(
            x0_sampler=lognormal_x0(bsb.x0, 0.3), objective="local")),
        "z_matching": (HestonPDE(), [3, 16, 16, 1], dict(
            objective="local", z_match_weight=1.0, z_match_mask=(0.0, 1.0))),
    }


@job
def dryrun(out: Path) -> dict:
    """The 12 configs of ``_dryrun_body`` at its sizes: each sharded run's
    final loss and Y0 beside the unsharded trainer's, the rank's state after
    the EMA configs, the 2-D (dp × tp) config and the checkpoint round
    trip."""
    import warnings

    warnings.simplefilter("ignore")
    n = dist.get_world_size()
    bsb = BlackScholesBarenblatt(D=8, T=1.0)
    mesh = parallel.make_mesh(n, devices=CPU)
    found = {"parity": {}, "states": {}}
    for name, (prob, layers, kw) in dryrun_configs(bsb).items():
        runs = {}
        for key, m in (("unsharded", None), ("sharded", mesh)):
            tr = Trainer(prob, M=4 * n, N=4, layers=layers, seed=0, mesh=m, device=CPU, **kw)
            runs[key] = _final(tr)
        found["parity"][name] = runs
        if tr.ema_decay is not None:
            found["states"][name] = local_state(tr)
    # the 2-D config: wide layers so that "tp" shards; dp·tp = n
    dp = n // 2
    mesh2d = parallel.make_mesh_2d(dp, 2, devices=CPU)
    runs = {}
    for key, m in (("unsharded", None), ("sharded", mesh2d)):
        tr = Trainer(bsb, M=4 * dp, N=4, layers=DP_TP_LAYERS, seed=0, mesh=m, device=CPU)
        if m is not None:
            found["tp_summary"] = parallel.tp_sharding_summary(tr.params)
        runs[key] = _final(tr)
    found["parity"]["dp_tp"] = runs
    found["states"]["dp_tp"] = local_state(tr)
    found["tp_index"] = mesh2d.get_local_rank("tp")
    # the checkpoint round trip: saved sharded, loaded by a fresh sharded
    # trainer of another seed, then trained on
    kw = dict(M=4 * n, N=4, layers=[9, 32, 32, 1], mesh=mesh, device=CPU)
    tr_a = Trainer(bsb, seed=0, **kw)
    _final(tr_a)
    path = out / "sharded.pt"
    tr_a.save_model(str(path))
    tr_b = Trainer(bsb, seed=1, **kw)
    tr_b.load_model(str(path))
    found["checkpoint"] = {
        "same": all(torch.equal(a, b) for a, b in zip(tr_a._params, tr_b._params)),
        "path": str(path), "params": [p.detach().clone() for p in tr_a._params],
        "resumed": _final(tr_b)}
    found["collectives"] = pdist.all_reduce.calls
    found["summary"] = parallel.global_device_summary()
    found["basics"] = mesh_basics(mesh)
    return found


def _raises(fn, exc=ValueError) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def mesh_basics(mesh) -> dict:
    """``tests/test_parallel.py``'s cases on this group's 1-D mesh."""
    n = dist.get_world_size()
    kw = dict(M=4 * n, N=4, layers=[5, 16, 16, 16, 16, 1], seed=3, device=CPU)
    prob = BlackScholesBarenblatt(D=4)
    plain, sharded = Trainer(prob, **kw), Trainer(prob, mesh=mesh, **kw)
    r1 = plain.train(6, 1e-3, log_every=3, verbose=False)
    r2 = sharded.train(6, 1e-3, log_every=3, verbose=False)
    params = ([p.detach().clone() for p in plain._params],
              [p.detach().clone() for p in sharded._params])
    seen, loss_fn = [], sharded.loss_fn

    def spy(net, ts, dWs, X0, **kw):
        seen.append((tuple(ts.shape), tuple(dWs.shape), tuple(X0.shape)))
        return loss_fn(net, ts, dWs, X0, **kw)

    sharded.loss_fn = spy
    sharded.step(*sharded._batch())
    return {
        "shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "divisible": _raises(lambda: parallel.check_divisible(4 * n, mesh)),
        "indivisible": _raises(lambda: parallel.check_divisible(4 * n + 1, mesh)),
        "too_many": _raises(lambda: parallel.make_mesh(n + 1, devices=CPU)),
        "too_few": _raises(lambda: parallel.make_mesh(n - 1, devices=CPU)),
        "trainer_indivisible": _raises(lambda: Trainer(prob, mesh=mesh, **dict(kw, M=4 * n + 1))),
        "placement": parallel.batch_sharding(mesh), "replicated": parallel.replicated(mesh),
        "rows_seen": seen,
        "losses": (r1.graph[1], r2.graph[1]),
        "params": params,
        "multi_host": parallel.is_multi_host(),
        "dp_backend": dist.get_backend(mesh.get_group("dp")),
    }


@job
def jax_parity(out: Path) -> dict:
    """Each case of ``inputs.pt``: the sharded trainer from the given
    weights on the given increments, three iterations logged one by one."""
    inputs = torch.load(out / "inputs.pt", weights_only=False)
    mesh = parallel.make_mesh(dist.get_world_size(), devices=CPU)
    found = {}
    for name, case in inputs.items():
        tr = Trainer(case["problem"], mesh=mesh, device=CPU, **case["trainer"])
        tr._load_full(case["weights"])
        draws = iter(case["draws"])
        tr._increments = lambda n: next(draws)
        res = tr.train(3, 1e-3, log_every=1, verbose=False)
        found[name] = {"losses": res.graph[1], "y0s": res.y0_history,
                       "params": model_sharding.full_state_dict(tr.net),
                       "ema": model_sharding.full_state_dict(tr.ema_params)}
    return found


def _net_grads(net, x, t):
    """(u, Z) of ``net`` at (t, x) and the gradient of Σu² + ΣZ² (through Z:
    a double backward) with respect to its parameters, whole."""
    from dnnpde_tpu_torch.solver import make_net_u

    u, Z = make_net_u(net)(t, x)
    grads = torch.autograd.grad((u**2).sum() + (Z**2).sum(), list(net.parameters()))
    dims = model_sharding.shard_dims(net)
    return u.detach(), Z.detach(), model_sharding.gather_full(grads, dims, net)


# the nets other than the MLP, whose sharded weights are gathered before use
IRREGULAR_MODES = ("Naisnet", "SDEnet", "Resnet", "Verlet")


@job
def tp(out: Path) -> dict:
    """``tests/test_model_sharding.py``'s cases on a 2 × 2 (dp × tp) mesh."""
    from dnnpde_tpu_torch.nets import MLP

    mesh = parallel.make_mesh_2d(2, 2, devices=CPU)
    found = {
        "shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "too_many": _raises(lambda: parallel.make_mesh_2d(4, 2, devices=CPU)),
        "backends": [dist.get_backend(mesh.get_group(n)) for n in ("dp", "tp")],
        "groups": [dist.get_process_group_ranks(mesh.get_group(n)) for n in ("dp", "tp")],
    }
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((4, 8), generator=gen)
    t = torch.rand((4, 1), generator=gen)
    for name, layers in (("wide", (9, 512, 512, 1)), ("narrow", (9, 32, 32, 1)),
                         ("deep", (9, 512, 512, 512, 1)), ("skip", (9, 512, 32, 32, 512, 1))):
        plain = MLP(layers, generator=torch.Generator().manual_seed(1), device=CPU)
        sharded = MLP(layers, generator=torch.Generator().manual_seed(1), device=CPU)
        parallel.shard_params_tp(sharded, mesh)
        found[name] = {"summary": parallel.tp_sharding_summary(sharded),
                       "plain": _net_grads(plain, x, t), "sharded": _net_grads(sharded, x, t),
                       "apply": (plain(torch.ones(4, 9)).detach(),
                                 sharded(torch.ones(4, 9)).detach())}
    prob = BlackScholesBarenblatt(D=8)
    kw = dict(M=8, N=3, layers=[9, 512, 512, 1], seed=5, device=CPU)
    tr_plain, tr_tp = Trainer(prob, **kw), Trainer(prob, mesh=mesh, **kw)
    found["training"] = [tr.train(4, 1e-3, log_every=2, verbose=False).graph[1]
                         for tr in (tr_plain, tr_tp)]
    found["weights"] = (dict(tr_plain.net.named_parameters()),
                        model_sharding.full_state_dict(tr_tp.net))
    found["local"] = local_state(tr_tp)
    found["tp_index"] = mesh.get_local_rank("tp")
    path = out / "tp.pt"
    tr_tp.save_model(str(path))
    found["checkpoint"] = str(path)
    for mode in IRREGULAR_MODES:
        kw = dict(M=8, N=3, layers=[9, 512, 512, 1], mode=mode, seed=3, device=CPU)
        runs = {}
        for key, m in (("plain", None), ("sharded", mesh)):
            tr = Trainer(prob, mesh=m, **kw)
            initial = model_sharding.full_state_dict(tr.net)
            _, grads = tr._loss_and_grads(*tr._batch(), noise=tr._noise)
            grads = model_sharding.gather_full(grads, model_sharding.shard_dims(tr.net), tr.net)
            runs[key] = {"initial": {k: v.clone() for k, v in initial.items()},
                         "grads": {k: g.clone() for k, g in zip(initial, grads, strict=True)},
                         "losses": tr.train(2, 1e-3, log_every=1, verbose=False).graph[1],
                         "weights": model_sharding.full_state_dict(tr.net)}
        runs["summary"] = parallel.tp_sharding_summary(tr.params)
        found[mode] = runs
    return found



@job
def shard_map(out: Path) -> dict:
    """``tests/test_shard_map.py``'s cases: M = 16 paths over the ranks."""
    from dnnpde_tpu_torch.nets import build_network
    from dnnpde_tpu_torch.train import build_optimizer

    mesh = parallel.make_mesh(dist.get_world_size(), devices=CPU)
    prob = BlackScholesBarenblatt(D=4)
    net = build_network("FC", [5, 16, 16, 16, 16, 1], "Sine",
                        generator=torch.Generator().manual_seed(0), device=CPU)
    tx = build_optimizer("Adam", 1e-3, clip_norm=None)
    initial = {k: v.detach().clone() for k, v in net.named_parameters()}
    step = parallel.make_shard_map_train_step(prob, net, tx, mesh, M=16, N=4)
    opt = tx.init(list(net.parameters()))
    _, opt, l1 = step(net, opt, 7)
    _, opt, l2 = step(net, opt, 1)
    found = {"initial": initial, "losses": (float(l1), float(l2)),
             "params": {k: v.detach().clone() for k, v in net.named_parameters()},
             "indivisible": _raises(lambda: parallel.make_shard_map_train_step(
                 prob, net, tx, mesh, M=14, N=4)),
             "index": mesh.get_local_rank("dp")}
    losses = []
    for i in range(30):
        _, opt, loss = step(net, opt, 100 + i)
        losses.append(float(loss))
    found["training"] = losses
    return found


@job
def dist_config(out: Path) -> dict:
    """``tests/test_distributed.py``'s configuration over the group."""
    mesh = parallel.make_mesh(devices=CPU)
    tr = Trainer(BlackScholesBarenblatt(D=4, T=1.0), M=8, N=4, layers=[5, 16, 16, 1],
                 mode="FC", activation="Sine", mesh=mesh, seed=0, device=CPU)
    res = tr.train(4, 1e-3, "Adam", log_every=2, verbose=False)
    return {"summary": parallel.global_device_summary(), "losses": res.graph[1]}


ENSEMBLE = dict(n_members=8, n_iter=20, M=16, N=4, layers=[5, 16, 16, 16, 16, 1],
                learning_rates=1e-3, seed=2, device=CPU)
SENSITIVITY_HPS = [
    {"initial_lr": 1e-3, "fine_tuning_lr": 1e-4, "initial_n_iter": 12, "fine_tuning_n_iter": 4},
    {"initial_lr": 1e-7, "fine_tuning_lr": 1e-8, "initial_n_iter": 4, "fine_tuning_n_iter": 2},
    {"initial_lr": 3e-3, "fine_tuning_lr": 1e-5, "initial_n_iter": 6, "fine_tuning_n_iter": 8},
    {"initial_lr": 1e-4, "fine_tuning_lr": 1e-3, "initial_n_iter": 2, "fine_tuning_n_iter": 10},
]


@job
def ensemble(out: Path) -> dict:
    """``tests/test_ensemble.py``'s sharded ensemble (8 members over the
    ranks), its divisibility error and the sharded sensitivity program."""
    from dnnpde_tpu_torch.train import train_ensemble, train_sensitivity_ensemble

    mesh = parallel.make_mesh(devices=CPU)
    prob = BlackScholesBarenblatt(D=4)
    res = train_ensemble(prob, mesh=mesh, **ENSEMBLE)
    return {
        "losses": res.losses, "y0s": res.y0s, "final_loss": res.final_loss,
        "params": res.params,
        "indivisible": _raises(lambda: train_ensemble(
            prob, n_members=3, n_iter=2, M=8, N=2, layers=[5, 8, 8, 1], mesh=mesh, device=CPU)),
        "sensitivity": train_sensitivity_ensemble(
            prob, SENSITIVITY_HPS, M=8, N=4, layers=[5, 16, 16, 1], mesh=mesh, device=CPU),
    }


def main() -> None:
    name, out = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    parallel.init_distributed(device=CPU)
    try:
        found = JOBS[name](out)
        torch.save(found, out / f"{name}.{dist.get_rank()}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
