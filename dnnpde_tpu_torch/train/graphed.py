"""The CUDA-graph chunk of the ``Trainer`` and the replica program. On a card
a chunk's first iteration is a real one, eager, on a side stream: the warm-up
that capture needs (autograd, cuBLAS workspaces and the kernels' first-use
load run outside the capture). The second is captured with the iteration's
generators registered, so a replay draws what an eager call would, and every
later one is a replay. A failed capture raises; nothing falls back to eager.
On the CPU, under ``train.detect_anomalies`` (whose checks read values back
to the host) and where the caller says so, every iteration runs eagerly."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from dnnpde_tpu_torch import tracing
from dnnpde_tpu_torch.train.diagnostics import anomalies_checked


def assign_state(dst: dict, src: dict, ok: Optional[torch.Tensor] = None) -> None:
    """Copy optimizer state ``src`` into the tensors of ``dst`` (where
    ``ok``, when given): the tensors a captured iteration binds."""
    for key, value in src.items():
        pairs = zip(dst[key], value) if isinstance(value, list) else [(dst[key], value)]
        for d, s in pairs:
            d.copy_(s if ok is None else torch.where(ok, s, d))


def clone_state(state: dict) -> dict:
    return {k: [x.clone() for x in v] if isinstance(v, list) else v.clone()
            for k, v in state.items()}


class CapturedChunk:
    """Up to ``capacity`` iterations of a training iteration whose tensors
    keep their addresses, each logging its loss and Y0 into ``losses`` and
    ``y0s`` ((capacity, *shape)) at the device-side index ``idx``."""

    def __init__(self, device: torch.device, dtype: torch.dtype, capacity: int,
                 shape: tuple = ()):
        self.device, self.capacity = device, capacity
        self.losses = torch.zeros((capacity, *shape), dtype=dtype, device=device)
        self.y0s = torch.zeros((capacity, *shape), dtype=dtype, device=device)
        self.idx = torch.zeros(1, dtype=torch.long, device=device)
        self.warm = False  # the warm-up has run
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._side_stream = None

    def log(self, loss: torch.Tensor, y0: torch.Tensor) -> None:
        row = (1,) + self.losses.shape[1:]
        self.losses.index_copy_(0, self.idx, loss.reshape(row))
        self.y0s.index_copy_(0, self.idx, y0.reshape(row))
        self.idx.add_(1)

    def iterate(self, body: Callable[[], None], k: int, it: int,
                generators: Sequence[torch.Generator], eager: bool = False) -> None:
        """Run k iterations of ``body``, the first numbered ``it``, logged
        from index 0."""
        self.idx.zero_()
        if eager or self.device.type != "cuda" or anomalies_checked():
            with tracing.span("dnnpde.train.eager", iterations=k):
                self._eager(body, k)
            tracing.count("train.eager_iterations", k)
            return
        done = 0
        with torch.cuda.device(self.device):
            if self.graph is None and k > 0:
                done = self._set_up(body, k, it, generators)
            if done < k:
                with tracing.span("dnnpde.train.replay", replays=k - done):
                    for _ in range(k - done):
                        self.graph.replay()
                tracing.count("train.graph_replays", k - done)

    def _eager(self, body: Callable[[], None], k: int) -> None:
        for _ in range(k):
            body()

    def _set_up(self, body: Callable[[], None], k: int, it: int,
                generators: Sequence[torch.Generator]) -> int:
        """The warm-up, unless it ran, then the capture if iterations
        remain; returns how many of the k iterations ran."""
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        done = 0
        if not self.warm:
            main = torch.cuda.current_stream(self.device)
            with tracing.span("dnnpde.train.warm_up", it=it):
                self._side_stream.wait_stream(main)
                with torch.cuda.stream(self._side_stream):
                    body()
                main.wait_stream(self._side_stream)
            tracing.count("train.eager_iterations")
            self.warm, done = True, 1
        if done < k:
            graph = torch.cuda.CUDAGraph()
            for g in generators:
                graph.register_generator_state(g)
            try:
                with tracing.span("dnnpde.train.capture", it=it + done), \
                        torch.cuda.graph(graph, stream=self._side_stream):
                    body()
            except RuntimeError as e:
                raise RuntimeError(
                    "capturing the training iteration into a CUDA graph failed; the "
                    "iteration must run on the device without host reads or synchronization"
                ) from e
            self.graph = graph
            tracing.count("train.graph_captures")
        return done
