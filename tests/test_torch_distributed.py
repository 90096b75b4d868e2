"""The port's multi-process training, on two and four gloo ranks on the
CPU: the counterparts of ``tests/test_distributed.py``. Every rank joins
one group through ``parallel.init_distributed`` (rendezvous over a file
store), the ranks train in lockstep through cross-process collectives and
report the same loss trajectory bit for bit, and that trajectory matches
the port's single-process trainer of the same seed (rtol 1e-5, as JAX's
test holds its distributed run to its single-process one). Unlike JAX's
test this one is not marked slow: a rank starts in a few seconds."""

from __future__ import annotations

import numpy as np
import pytest

from dnnpde_tpu_torch.pde import BlackScholesBarenblatt
from dnnpde_tpu_torch.train import Trainer
from torch_parallel_workers import run_job

CONFIG = dict(D=4, M=8, N=4, layers=[5, 16, 16, 1], iters=4, seed=0)


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def dist_results(request, tmp_path_factory):
    return run_job("dist_config", request.param, tmp_path_factory.mktemp("dist"))


@pytest.fixture(scope="module")
def single_process():
    tr = Trainer(BlackScholesBarenblatt(D=CONFIG["D"], T=1.0), M=CONFIG["M"], N=CONFIG["N"],
                 layers=CONFIG["layers"], mode="FC", activation="Sine", seed=CONFIG["seed"],
                 device="cpu")
    return tr.train(CONFIG["iters"], 1e-3, "Adam", log_every=2, verbose=False).graph[1]


def test_processes_form_one_global_mesh(dist_results):
    n = len(dist_results)
    for rank, r in enumerate(dist_results):
        assert r["summary"] == {"process_index": rank, "process_count": n,
                                "local_devices": 1, "global_devices": n}


def test_processes_agree_on_loss_trajectory(dist_results):
    losses = [r["losses"] for r in dist_results]
    assert len(losses[0]) >= 2
    for other in losses[1:]:
        np.testing.assert_allclose(losses[0], other, rtol=0, atol=0)


def test_distributed_matches_single_process(dist_results, single_process):
    np.testing.assert_allclose(dist_results[0]["losses"], single_process, rtol=1e-5)


# (coordinator_address, num_processes, process_id, this host's LOCAL_* variables,
# the host's cards) -> backend and card, or None where the host's share of the
# ranks is unknown and init_distributed raises
LAYOUTS = {
    "two-hosts-of-8-cards": ("10.0.0.1:1234", 16, 9, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "8"},
                             8, ("nccl", 1)),
    "two-hosts-unknown-share": ("10.0.0.1:1234", 16, 9, {}, 8, None),
    "one-host-one-card-a-rank": ("127.0.0.1:1234", 2, 1, {}, 2, ("nccl", 1)),
    "one-host-two-ranks-share-a-card": ("localhost:1234", 2, 1, {}, 1, ("gloo", 0)),
    "file-store-three-ranks-two-cards": ("file:///tmp/store", 3, 2, {}, 2, ("gloo", 0)),
    "more-local-ranks-than-cards": ("10.0.0.1:1234", 16, 9,
                                    {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, 2, ("gloo", 1)),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_backend_follows_this_hosts_ranks_and_cards(case, monkeypatch):
    """The backend and card come from this host's ranks and cards (counts
    monkeypatched here; no group is formed): NCCL exactly when each of the
    host's ranks has a card of its own. On an address that may span hosts
    with no local layout given, init_distributed raises instead of taking
    the whole world for this host's ranks."""
    import torch
    import torch.distributed as dist

    from dnnpde_tpu_torch.parallel import distributed as pdist

    address, world, rank, env, n_cards, expected = LAYOUTS[case]
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", pdist.STORE_ENV):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    seen = {}
    monkeypatch.setattr(pdist, "default_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda card: seen.update(card=card.index))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    if expected is None:
        with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
            pdist.init_distributed(address, world, rank)
        assert not seen
        return
    pdist.init_distributed(address, world, rank)
    assert (seen["backend"], seen["card"]) == expected
    assert (seen["world_size"], seen["rank"]) == (world, rank)
    assert ("device_id" in seen) == (expected[0] == "nccl")
