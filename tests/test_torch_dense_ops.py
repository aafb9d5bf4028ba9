"""The JAX package's ops that no path of it calls, ported as plain
functions: sh_encode, trunc_exp, biased_softplus, the dense (N, K)
render_weights and accumulate, and the dense sdf_losses and
orientation_loss, against the JAX package on the CPU.

Tolerances: rtol 1e-5 with atol 1e-6 (float32 elementwise math and short
sums in another order); sh_encode's higher degrees at atol 1e-5 (the
Legendre recurrence's constants reach ~1e2 for degree 8); trunc_exp's
derivative at rtol 1e-6 (one exp of the same clamped value).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from morpheus_tpu.ops import density as jdensity  # noqa: E402
from morpheus_tpu.ops import encodings as jenc  # noqa: E402
from morpheus_tpu.ops import volrender as jvol  # noqa: E402
from morpheus_tpu.train import losses as jlosses  # noqa: E402
from morpheus_tpu_torch.ops import density, encodings, volrender  # noqa: E402
from morpheus_tpu_torch.train import losses  # noqa: E402

T = torch.as_tensor


def close(a, b, rtol=1e-5, atol=1e-6):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_sh_encode(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(97, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [0.0, 0.0, 1.0]                       # the pole: sin(theta) = 0
    got = encodings.sh_encode(T(d), degree)
    assert got.shape == (97, encodings.sh_output_dim(degree))
    close(got, jenc.sh_encode(jnp.asarray(d), degree=degree),
          atol=1e-5 if degree == 8 else 1e-6)
    with pytest.raises(ValueError, match="degree"):
        encodings.sh_encode(T(d), 9)


def test_trunc_exp_and_biased_softplus():
    x = np.array([-3.0, 0.0, 2.5, 14.9, 15.0, 16.0, 20.0], np.float32)
    xt = T(x).requires_grad_()
    y = density.trunc_exp(xt)
    close(y, jdensity.trunc_exp(jnp.asarray(x)))
    (g,) = torch.autograd.grad(y.sum(), xt)
    jg = jax.grad(lambda v: jnp.sum(jdensity.trunc_exp(v)))(jnp.asarray(x))
    close(g, jg, rtol=1e-6)
    assert float(g[-1]) == pytest.approx(np.exp(np.float32(15.0)), rel=1e-6)
    close(density.biased_softplus(T(x), 0.5),
          jdensity.biased_softplus(jnp.asarray(x), 0.5))


def _dense(seed=0, N=13, K=9):
    rng = np.random.default_rng(seed)
    t0 = np.sort(rng.uniform(0.5, 3.0, (N, K)), -1).astype(np.float32)
    t1 = (t0 + rng.uniform(0.001, 0.05, (N, K))).astype(np.float32)
    sig = rng.uniform(0, 40, (N, K)).astype(np.float32)
    mask = rng.uniform(size=(N, K)) > 0.25
    return rng, t0, t1, sig, mask


def test_render_weights_and_accumulate():
    rng, t0, t1, sig, mask = _dense()
    got = volrender.render_weights(T(t0), T(t1), T(sig), T(mask))
    want = jvol.render_weights(t0, t1, sig, mask)
    for g, w in zip(got, want):
        close(g, w)
    vals = rng.normal(size=t0.shape + (3,)).astype(np.float32)
    close(volrender.accumulate(got[0], T(vals)),
          jvol.accumulate(want[0], vals))
    close(volrender.accumulate(got[0]), jvol.accumulate(want[0]))


def test_dense_sdf_losses_and_orientation_loss():
    rng, t0, t1, _, mask = _dense(seed=1)
    N, K = t0.shape
    tm = (0.5 * (t0 + t1)).astype(np.float32)
    depth = rng.uniform(-0.5, 3, (N, 1)).astype(np.float32)
    depth[1] = 0.0
    sdf = (rng.normal(size=tm.shape) * 0.1).astype(np.float32)
    rmask = (rng.uniform(size=(N, 1)) > 0.3).astype(np.float32)
    for rm in (None, rmask):
        got = losses.sdf_losses(T(tm), T(depth), T(sdf), 0.1, T(mask),
                                None if rm is None else T(rm))
        want = jlosses.sdf_losses(tm, depth, sdf, 0.1, mask, rm)
        for g, w in zip(got, want):
            close(g, w)
    w = rng.uniform(size=(N, K)).astype(np.float32)
    n = rng.normal(size=(N, K, 3)).astype(np.float32)
    d = rng.normal(size=(N, K, 3)).astype(np.float32)
    close(losses.orientation_loss(T(w), T(n), T(d), T(mask)),
          jlosses.orientation_loss(w, n, d, mask))
