"""CUDA graphs of the Zero123 UNet's forward (zero123.apply_unet's body:
the inputs' cast to the compute type, the UNet, the cast of its output to
float32), one a key, held by each Zero123Guidance.

At CFG batch 2 on a 32^2 latent the forward is ~1,300 small kernels whose
launches from Python take several times their device time; a replay
launches them all at once. A key's first call captures its graph through
graphs.capture (an eager warm-up on a side stream, whose output the call
returns, then the capture; capture_s and pool_mb on the graph). A graph
reads the addresses it saw at capture: its inputs are copied into static
buffers, the UNet's weights are read where they lie (an in-place copy_
into a weight is followed by the replay), and the output is a static
buffer that the next replay overwrites, so each replay returns a clone of
it.

A graph's key (key()) holds the inputs' shapes and dtypes, and the state
that decides which kernels an eager call runs and what they read: the
device, the compute type, the backend settings in force (settings()) and
the addresses of the UNet's parameters and buffers. A graph whose state no
longer holds (a weight rebound by a cast, a .to() or an assigning
load_state_dict; a settings change) is dropped at the next call, as the
trainer drops a step graph that no longer fits.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import graphs, trace


def settings() -> tuple:
    """The backend settings under which an eager call picks its kernels:
    TF32 in float32 convolutions and matrix products."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


class _Graph:
    """One capture of body(x, t, context) on static copies of the inputs
    (graph: its graphs.Graph); built by capture(), which returns the
    warm-up's output beside it."""

    def __init__(self, inputs, graph):
        self.inputs, self.graph = inputs, graph

    @classmethod
    def capture(cls, body, x, t, context) -> tuple:
        inputs = [a.clone() for a in (x, t, context)]
        out, graph = graphs.capture(lambda: body(*inputs), x.device)
        return out, cls(inputs, graph)

    def replay(self, x, t, context) -> torch.Tensor:
        for s, a in zip(self.inputs, (x, t, context)):
            s.copy_(a)
        return self.graph.replay().clone()


class UNetGraphs:
    """The graphs of one UNet's forward, by key (see the module
    docstring)."""

    def __init__(self, unet: nn.Module):
        # the modules' own tables, read at each call: a rebound weight
        # shows there, whether its Parameter or only its data was replaced
        self._tables = [d for m in unet.modules()
                        for d in (m._parameters, m._buffers) if d]
        self.graphs: dict = {}

    def key(self, x, t, context, compute_dtype: str) -> tuple:
        """(the inputs' part, the state's part)."""
        inputs = tuple((tuple(a.shape), a.dtype) for a in (x, t, context))
        ptrs = tuple(p.data_ptr() for d in self._tables
                     for p in d.values() if p is not None)
        return inputs, (x.device, compute_dtype, settings(), ptrs)

    def __call__(self, body, x, t, context, compute_dtype: str
                 ) -> torch.Tensor:
        """body(x, t, context) on CUDA inputs: a replay of this key's graph,
        or at a key's first call body's eager output, the graph captured
        after it (_Graph.capture). Graphs whose state no longer holds are
        dropped first. A failed capture raises."""
        key = self.key(x, t, context, compute_dtype)
        for k in [k for k in self.graphs if k[1] != key[1]]:
            del self.graphs[k]
        graph = self.graphs.get(key)
        if graph is not None:
            trace.count("unet.replays")
            return graph.replay(x, t, context)
        out, self.graphs[key] = _Graph.capture(body, x, t, context)
        return out
