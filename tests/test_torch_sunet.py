"""Parity of the port's SUNet (``vwfd_tpu_torch/nets/sunet.py``) and K18's
plain version (``kernels/window_attention.py``) with vwfd_tpu's, on the CPU
in float32, from the same weights (the port's ``init_params`` carried to a
flax tree by ``convert.py``; JAX's side jitted).

Tolerances and why (float32 CPU einsums and matrix products sum in another
order than XLA's; flax's LayerNorm variance is E[x²] − E[x]², PyTorch's
two-pass):

* ``WindowAttention`` on the map (qkv Dense, K18's plain version in the
  map layout, proj Dense) against JAX's roll, partition, attention,
  reverse and roll back, forward and every gradient (the input's, both
  Dense layers', the bias table's): within 1e-5 of the tensor's max-abs,
  shifted and unshifted, N = 16 and 64, square and non-square maps;
* ``SUNet`` at a narrow width (embed 32, depths (2, 2), heads (1, 2),
  window 4, 32², batch 2: stage 0 shifts, stage 1 does not), output within
  1e-5 of its max, every parameter's gradient within 1e-4 of its tensor's
  max-abs (the gradients pass two Swin stages, two dual up-samples and
  eight LayerNorms back);
* ``SUNet`` at the published widths (embed 96, (2, 2, 2, 2), (3, 6, 12,
  24), window 8) at 64², batch 1: output within 1e-5 of its max;
* the converters: EQUAL both ways, the LayerNorm ``scale`` → ``weight``
  rule, ``rel_pos_bias`` and the PReLU slopes included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.nets import sunet as jsunet
from vwfd_tpu_torch.convert import (_state_dict_to_tree, state_dict_from_jax,
                                    state_dict_to_jax)
from vwfd_tpu_torch.kernels import PLAIN
from vwfd_tpu_torch.kernels import window_attention as k18
from vwfd_tpu_torch.nets import sunet

RTOL = 1e-5
GRAD_RTOL = 1e-4
NARROW = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().cpu().numpy()


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _grads_close(port_net, jgrads, rel):
    """Every parameter's gradient of the port against the JAX tree's."""
    g_sd = {k: p.grad for k, p in port_net.named_parameters()}
    want = state_dict_from_jax(_tree(jgrads))
    assert set(want) == set(g_sd)
    for k, w in want.items():
        _close(_np(g_sd[k]), _np(w), rel, k)


# --------------------------------------------------------- WindowAttention

@pytest.mark.parametrize("ws,grid,shift,heads", [
    (8, (2, 3), 0, 2), (8, (2, 2), 4, 3), (4, (2, 2), 2, 2),
    (4, (1, 1), 0, 1), (8, (3, 2), 4, 2)])
def test_window_attention_matches_jax(ws, grid, shift, heads):
    """The port's ``WindowAttention`` on the map (the qkv Dense, K18's plain
    version in the map layout, proj) against JAX's roll by −shift →
    ``window_partition`` → ``WindowAttention`` (JAX's mask for the window
    grid and shift) → ``window_reverse`` → roll back on the same map,
    forward and VJP: N = ws², batch 2 images of ``grid`` windows. The last
    case's shift wraps both edges of a non-square map."""
    c = 32 * heads
    hh, ww = grid[0] * ws, grid[1] * ws
    rng = np.random.default_rng(ws * 10 + shift + grid[0])
    x = rng.standard_normal((2, hh, ww, c)).astype(np.float32)
    cot = rng.standard_normal((2, hh, ww, c)).astype(np.float32)
    mod = jsunet.WindowAttention(c, heads, ws)
    mask = (jnp.asarray(k18.shift_mask(ws, hh, ww, shift)) if shift
            else None)
    port = sunet.WindowAttention(c, heads, ws)
    with torch.no_grad():  # a table far from 0, so that its gradient counts
        for t in port.parameters():
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape))
                                     .astype(np.float32) * 0.2))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    state_dict_to_jax(port.state_dict())[0])
    if shift:  # the JAX mask equals the port's, from JAX's own code
        img = np.zeros((1, hh, ww, 1))
        cnt = 0
        for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            for wsl in (slice(0, -ws), slice(-ws, -shift),
                        slice(-shift, None)):
                img[:, hs, wsl] = cnt
                cnt += 1
        mw = np.asarray(jsunet.window_partition(jnp.asarray(img), ws)
                        ).reshape(-1, ws * ws)
        np.testing.assert_array_equal(
            np.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0),
            k18.shift_mask(ws, hh, ww, shift))

    def on_map(p_, x_):  # SwinBlock's moves around JAX's WindowAttention
        y = jnp.roll(x_, (-shift, -shift), axis=(1, 2)) if shift else x_
        wins = jsunet.window_partition(y, ws).reshape(-1, ws * ws, c)
        out = mod.apply({"params": p_}, wins, mask)
        y = jsunet.window_reverse(out.reshape(-1, ws, ws, c), ws, hh, ww)
        return jnp.roll(y, (shift, shift), axis=(1, 2)) if shift else y

    @jax.jit
    def f(p, xx, cc):
        out, vjp = jax.vjp(on_map, p, xx)
        return out, vjp(cc)
    want, (gp, gx) = f(params, jnp.asarray(x), jnp.asarray(cot))

    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt, ws, shift, PLAIN)
    got.backward(torch.from_numpy(cot))
    _close(_np(got), want, RTOL, "forward")
    _close(_np(xt.grad), gx, RTOL, "input gradient")
    _grads_close(port, gp, RTOL)


def test_window_attention_plain_routes_cpu_tensors():
    """``KERNELS.window_attention`` on CPU tensors is the plain version,
    bit for bit, and the plain version on the map is the window attention
    of the rolled, partitioned map put back; K18's shape rules raise only
    on a CUDA tensor."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((1, 8, 12, 3, 2, 32)).astype(
        np.float32))
    table = torch.from_numpy(rng.standard_normal((49, 2)).astype(np.float32))
    want = k18.window_attention_plain(qkv, table, 4, 2)
    assert torch.equal(k18.window_attention(qkv, table, 4, 2), want)
    assert want.shape == (1, 8, 12, 64)
    rolled = torch.roll(qkv, (-2, -2), dims=(1, 2)).reshape(1, 8, 12, -1)
    wins = k18.window_partition(rolled, 4).reshape(6, 16, 3, 2, 32)
    body = k18._windows_plain(wins, table, (2, 3), 2)
    back = torch.roll(k18.window_reverse(body.reshape(6, 4, 4, 64), 4, 8, 12),
                      (2, 2), dims=(1, 2))
    assert torch.equal(back, want)
    with pytest.raises(ValueError, match="tile"):
        k18._check(qkv[:, :7], table, 4, 0)
    with pytest.raises(ValueError, match="d in"):
        k18._check(qkv[..., :8].contiguous(), table, 4, 0)
    with pytest.raises(ValueError, match="table"):
        k18._check(qkv, table[:9], 4, 0)
    with pytest.raises(ValueError, match="shift"):
        k18._check(qkv, table, 4, 4)
    with pytest.raises(ValueError, match=r"\(B, Hm, Wm"):
        k18._check(qkv[0], table, 4, 0)
    with pytest.raises(TypeError):
        k18._check(qkv.double(), table, 4, 0)
    big = torch.zeros(1, 9, 9, 3, 1, 32)
    with pytest.raises(ValueError, match="windows up to"):
        k18._check(big, torch.zeros(289, 1), 9, 0)


def test_work_counts_stage_0_at_256_b8():
    """The bound's inputs at 256² b8 stage 0 (the 64 × 64 map, windows of
    8): 37.7 + 12.6 MB and 0.805 GFLOP forward."""
    b, f = k18.work((8, 64, 64, 3, 3, 32), 8)
    assert abs(b - (37.7e6 + 12.6e6)) < 0.1e6
    assert abs(f - 0.805e9) < 0.001e9


# ------------------------------------------------------------------ SUNet

def _pair(size, batch, seed, **kw):
    """JAX's SUNet and the port's from the same weights: the port's
    ``init_params`` carried to a flax tree by ``convert.py`` (flax's own
    ``init`` runs op by op, minutes at these sizes; the tree's structure
    and shapes are held to its ``eval_shape``), and a batch."""
    net = jsunet.SUNet(out_channels=1, apply_sigmoid=True, **kw)
    x = np.random.default_rng(seed).random((batch, size, size, 3)
                                            ).astype(np.float32)
    port = sunet.SUNet(out_channels=1, apply_sigmoid=True, image_size=size,
                       kernels=PLAIN, **kw)
    port.init_params(torch.Generator().manual_seed(seed))
    params, _ = state_dict_to_jax(port.state_dict())
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros_like(x))["params"]
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    return net, jax.tree_util.tree_map(jnp.asarray, params), port, x


def test_sunet_narrow_matches_jax():
    """Forward and every parameter's gradient at the narrow width (stage 0
    shifted, stage 1 not), from converted weights."""
    net, params, port, x = _pair(32, 2, 5, **NARROW)
    cot = np.random.default_rng(6).standard_normal((2, 32, 32, 1)).astype(
        np.float32)
    @jax.jit
    def f(p, cc):
        out, vjp = jax.vjp(lambda q: net.apply({"params": q}, x), p)
        return out, vjp(cc)[0]
    want, gp = f(params, jnp.asarray(cot))
    got = port(torch.from_numpy(x))
    got.backward(torch.from_numpy(cot))
    assert got.shape == (2, 32, 32, 1)
    _close(_np(got), want, RTOL, "forward")
    _grads_close(port, gp, GRAD_RTOL)
    blk = port.enc0_blk1
    assert blk.attn.rel_pos_bias.shape == (49, 1)
    assert port.dec0_blk1.norm1.eps == 1e-6


def test_sunet_published_widths_forward():
    """The published widths at 64², batch 1, through ``convert.py``:
    forward within 1e-5 of its max; windows 8, 8, 4 and 2 at the four
    stages (tables 225, 225, 49, 9 rows)."""
    net, params, port, x = _pair(64, 1, 7)
    want = jax.jit(lambda p: net.apply({"params": p}, x))(params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(_np(got), want, RTOL, "forward")
    rows = [getattr(port, f"enc{i}_blk0").attn.rel_pos_bias.shape[0]
            for i in range(4)]
    assert rows == [225, 225, 49, 9]
    n = sum(p.numel() for p in port.parameters())
    assert n == sum(np.asarray(a).size
                    for a in jax.tree_util.tree_leaves(params))


def test_sunet_converts_both_ways():
    """``convert.py`` carries SUNet's flax tree (flax's own ``init``, jitted)
    to the port and back EQUAL: LayerNorm ``scale`` → ``weight``,
    ``rel_pos_bias`` beside ``qkv`` and ``proj``, the PReLU slopes
    (scalars)."""
    net = jsunet.SUNet(out_channels=1, apply_sigmoid=True, **NARROW)
    tree = _tree(jax.jit(net.init)(jax.random.PRNGKey(8),
                                   jnp.zeros((1, 32, 32, 3)))["params"])
    port = sunet.SUNet(out_channels=1, apply_sigmoid=True, image_size=32,
                       **NARROW)
    port.load_state_dict(state_dict_from_jax(tree))
    sd = state_dict_from_jax(tree)
    assert sd["embed_norm.weight"].shape == (32,)
    assert sd["up0.PReLU_0.negative_slope"].shape == ()
    assert float(sd["up0.PReLU_1.negative_slope"]) == pytest.approx(0.01)
    assert sd["enc0_blk0.attn.rel_pos_bias"].shape == (49, 1)
    back, stats = state_dict_to_jax(port.state_dict())
    assert stats == {}
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a, err_msg=str(path))
    # the optimizer's trees take the same rules (no BatchNorm in SUNet)
    mu, _ = _state_dict_to_tree(dict(port.named_parameters()), set())
    assert set(mu["norm_up"]) == {"scale", "bias"}


def test_sunet_init_is_flax_shaped():
    """``init_params``: LayerNorms at (1, 0), PReLU slopes 0.01, zero biases,
    tables of std about 0.02 within ±0.04, Dense kernels of std about
    fan_in^-½."""
    net = sunet.SUNet(image_size=64, **NARROW)
    net.init_params(torch.Generator().manual_seed(0))
    assert torch.equal(net.embed_norm.weight, torch.ones(32))
    assert float(net.up0.PReLU_0.negative_slope.detach()) == pytest.approx(
        0.01)
    assert torch.equal(net.enc0_blk0.fc1.bias, torch.zeros(128))
    t = net.enc1_blk0.attn.rel_pos_bias.detach()
    assert float(t.abs().max()) <= 0.04 and 0.01 < float(t.std()) < 0.03
    w = net.enc1_blk0.fc1.weight.detach()
    assert abs(float(w.std()) * 64 ** 0.5 - 1.0) < 0.1
