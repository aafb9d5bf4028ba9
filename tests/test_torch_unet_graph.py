"""The CUDA graphs of the Zero123 UNet's forward (guidance/unet_graph.py) on
the CPU: apply_unet on CPU tensors runs the eager body and counts its call;
the graphs' key holds the inputs' shapes and dtypes, the compute type, the
backend settings and the UNet's weight addresses; the holder replays a
key's graph and drops one whose state no longer holds (a stub of
graphs.capture stands in for CUDA's); the host counters of trace.py beside
the fill counters; and the benchmark's reader of the graphs' share."""
import importlib.util
import os

import pytest
import torch

from graph_stubs import stub_capture
from morpheus_tpu_torch import trace
from morpheus_tpu_torch.guidance import zero123 as z123

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_KW = dict(image_size=16, unet_channels=32, unet_mult=(1, 2),
               unet_heads=2, context_dim=16, clip_width=32, clip_layers=1,
               clip_heads=2, clip_patch=14, vae_ch=32, vae_mult=(1, 2),
               vae_res_blocks=1)


def guidance(compute_dtype: str = "float32") -> z123.Zero123Guidance:
    """A tiny guidance whose UNet weights are all random and non-zero
    (init_random zeroes the output convs, and a zero epsilon would pass any
    comparison)."""
    g = z123.Zero123Guidance.init_random(
        z123.Zero123Spec(**SPEC_KW, compute_dtype=compute_dtype), "cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in g.unet.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return g


def inputs(g, batch: int = 2, seed: int = 0) -> tuple:
    gen = torch.Generator().manual_seed(seed)
    h = g.spec.latent_size
    return (torch.randn(batch, 8, h, h, generator=gen),
            torch.randint(0, 1000, (batch,), generator=gen),
            torch.randn(batch, 1, g.spec.context_dim, generator=gen))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cpu_apply_unet_is_the_eager_body(compute_dtype):
    g = guidance(compute_dtype)
    x, t, c = inputs(g)
    dt = getattr(torch, compute_dtype)
    trace.reset()
    got = z123.apply_unet(g, x, t, c)
    with torch.no_grad():
        want = g.unet(x.to(dt), t, c.to(dt)).float()
    assert got.dtype == torch.float32 and float(want.abs().max()) > 0
    assert torch.equal(got, want)
    counts = trace.read()
    assert counts["unet.calls"] == 1.0
    assert counts.get("unet.replays", 0.0) == 0.0
    assert not g.unet_graphs.graphs


def _rebind(g):
    w = g.unet.out[2].weight
    w.data = w.data.clone()


def _reassign(g):
    conv = g.unet.out[2]
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone(),
                                     requires_grad=False)


def _copy_in_place(g):
    with torch.no_grad():
        g.unet.out[2].weight.mul_(2.0)


# (name, what changes, whether the key changes)
KEY_CASES = [
    ("equal_inputs", lambda g, a, s: None, False),
    ("in_place_weight_copy", lambda g, a, s: _copy_in_place(g), False),
    ("x_shape", lambda g, a, s: a.__setitem__(0, torch.zeros(2, 8, 4, 4)),
     True),
    ("batch", lambda g, a, s: a.__setitem__(
        slice(0, 3), list(inputs(g, batch=4))), True),
    ("x_dtype", lambda g, a, s: a.__setitem__(0, a[0].double()), True),
    ("t_dtype", lambda g, a, s: a.__setitem__(1, a[1].int()), True),
    ("context_dtype", lambda g, a, s: a.__setitem__(
        2, a[2].to(torch.bfloat16)), True),
    ("compute_dtype", lambda g, a, s: a.__setitem__(3, "bfloat16"), True),
    ("cudnn_tf32", lambda g, a, s: s.setattr(
        torch.backends.cudnn, "allow_tf32",
        not torch.backends.cudnn.allow_tf32), True),
    ("matmul_tf32", lambda g, a, s: s.setattr(
        torch.backends.cuda.matmul, "allow_tf32",
        not torch.backends.cuda.matmul.allow_tf32), True),
    ("rebound_weight_data", lambda g, a, s: _rebind(g), True),
    ("reassigned_parameter", lambda g, a, s: _reassign(g), True),
]


@pytest.mark.parametrize("name,change,changes", KEY_CASES,
                         ids=[c[0] for c in KEY_CASES])
def test_key(name, change, changes, monkeypatch):
    g = guidance()
    args = [*inputs(g), g.spec.compute_dtype]
    before = g.unet_graphs.key(*args)
    args = [*inputs(g, seed=1), g.spec.compute_dtype]   # equal, not the same
    change(g, args, monkeypatch)
    after = g.unet_graphs.key(*args)
    assert (after != before) == changes
    # only the inputs' part tells inputs apart
    inputs_part = name in ("x_shape", "batch", "x_dtype", "t_dtype",
                           "context_dtype")
    assert (after[0] != before[0]) == inputs_part


def test_graphs_replay_a_key_and_drop_what_no_longer_holds(monkeypatch):
    made = []
    stub_capture(monkeypatch, made)
    g = guidance()
    graphs = g.unet_graphs

    def run(x, t, c):
        return graphs(lambda *a: z123._unet_body(g, *a), x, t, c,
                      g.spec.compute_dtype)

    trace.reset()
    a, b = inputs(g, seed=0), inputs(g, seed=1)
    want = [z123._unet_body(g, *a), z123._unet_body(g, *b)]
    assert torch.equal(run(*a), want[0])             # captured
    assert torch.equal(run(*b), want[1])             # replayed
    assert torch.equal(run(*a), want[0])             # replayed
    assert len(made) == 1 and len(graphs.graphs) == 1
    assert trace.read()["unet.replays"] == 2.0
    run(*inputs(g, batch=4))                         # a second key
    assert len(made) == 2 and len(graphs.graphs) == 2
    _rebind(g)                                       # both keys fail
    run(*a)
    assert len(made) == 3 and len(graphs.graphs) == 1
    assert trace.read()["unet.replays"] == 2.0
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        not torch.backends.cuda.matmul.allow_tf32)
    run(*a)
    assert len(made) == 4 and len(graphs.graphs) == 1


def test_host_counters_beside_the_fill_counters():
    trace.allocate(("hc",), "cpu")
    trace.reset()
    trace.count("hc.calls")
    trace.count("hc.calls", 2.0)
    trace.fill("hc", torch.tensor([True, False, True]))
    got = trace.read()
    assert got["hc.calls"] == 3.0
    assert got["hc.samples_valid"] == 2.0 and got["hc.samples_slots"] == 3.0
    trace.reset()
    got = trace.read()
    assert got["hc.calls"] == 0.0 and got["hc.samples_valid"] == 0.0
    trace.count("hc.calls")
    assert trace.read()["hc.calls"] == 1.0
    trace.reset()


def _reader():
    path = os.path.join(ROOT, "benchmark", "metrics", "unet.graph_share.py")
    spec = importlib.util.spec_from_file_location("unet_graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_graph_share_reader(monkeypatch):
    read = _reader()
    monkeypatch.setattr(trace, "_host", {})
    assert read(None) is None                       # no counters
    trace.count("unet.calls")
    trace.reset()
    assert read(None) is None                       # none counted
    for _ in range(4):
        trace.count("unet.calls")
    assert read(None) == 0.0
    for _ in range(3):
        trace.count("unet.replays")
    assert read(None) == pytest.approx(75.0)
