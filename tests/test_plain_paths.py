"""The plain JAX paths of the hot layers against independent float64 numpy
oracles: the GAE scan, the LSTM and GRU sequence scans, entity
self-attention and layer norm. Gradients are checked numerically with
``jax.test_util.check_grads``. Shapes are those the fused kernels these
paths replaced were tested at (odd batch sizes, single steps, entity sets
past 256).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

from madrona_learn_tpu import nn
from madrona_learn_tpu.models import GRU, LSTM, EntitySelfAttentionNet
from madrona_learn_tpu.models.attention import SelfAttention
from madrona_learn_tpu.models.common import LayerNorm
from madrona_learn_tpu.models.gru import gru_sequence
from madrona_learn_tpu.models.lstm import lstm_sequence
from madrona_learn_tpu.ops.gae import compute_advantages
from madrona_learn_tpu.struct import FrozenDict


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _f64(*xs):
    return [np.asarray(x, np.float64) for x in xs]


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------

def np_gae(gamma, lam, rewards, values, dones, bootstrap):
    """[T, N] inputs, [N] bootstrap -> [T, N] advantages."""
    rewards, values, bootstrap = _f64(rewards, values, bootstrap)
    dones = np.asarray(dones, bool)
    adv = np.zeros_like(rewards)
    next_adv = np.zeros_like(bootstrap)
    next_val = bootstrap
    for t in reversed(range(rewards.shape[0])):
        live = ~dones[t]
        delta = rewards[t] + gamma * np.where(live, next_val, 0) - values[t]
        next_adv = delta + gamma * lam * np.where(live, next_adv, 0)
        adv[t] = next_adv
        next_val = values[t]
    return adv


def np_lstm_sequence(xp, ends, wr, b, c0, h0):
    xp, wr, b, c, h = _f64(xp, wr, b, c0, h0)
    ys = []
    for t in range(xp.shape[0]):
        i, f, g, o = np.split(xp[t] + h @ wr + b, 4, axis=-1)
        c = _sigmoid(f) * c + _sigmoid(i) * np.tanh(g)
        h = _sigmoid(o) * np.tanh(c)
        ys.append(h)
        c = np.where(ends[t], 0, c)
        h = np.where(ends[t], 0, h)
    return np.stack(ys)


def np_gru_sequence(xp, ends, wh, bh, h0):
    xp, wh, bh, h = _f64(xp, wh, bh, h0)
    H = h.shape[-1]
    ys = []
    for t in range(xp.shape[0]):
        hp = h @ wh
        r = _sigmoid(xp[t, :, :H] + hp[:, :H])
        z = _sigmoid(xp[t, :, H:2 * H] + hp[:, H:2 * H])
        n = np.tanh(xp[t, :, 2 * H:] + r * (hp[:, 2 * H:] + bh))
        h = (1 - z) * n + z * h
        ys.append(h)
        h = np.where(ends[t], 0, h)
    return np.stack(ys)


def np_softmax(s, mask=None):
    if mask is not None:
        s = np.where(mask, s, -np.inf)
    e = np.exp(s - s.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def np_self_attention(x, p):
    """linen-style MHA params -> [..., S, out]."""
    x = np.asarray(x, np.float64)
    proj = {k: _f64(p[k]["kernel"], p[k]["bias"])
            for k in ("query", "key", "value", "out")}
    q, k, v = (np.einsum("...sf,fhd->...shd", x, w) + b
               for w, b in (proj["query"], proj["key"], proj["value"]))
    s = np.einsum("...qhd,...khd->...hqk", q, k) / np.sqrt(q.shape[-1])
    o = np.einsum("...hqk,...khd->...qhd", np_softmax(s), v)
    w, b = proj["out"]
    return np.einsum("...qhd,hdo->...qo", o, w) + b


def np_layer_norm(x, scale, bias, eps=1e-6):
    x, scale, bias = _f64(x, scale, bias)
    mu = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * scale + bias


# ---------------------------------------------------------------------------
# GAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,TC,P,B", [(1, 32, 1, 700), (2, 8, 2, 96),
                                      (4, 8, 3, 33)])
def test_gae_scan_matches_numpy(C, TC, P, B):
    rng = np.random.default_rng(C * 100 + B)
    shape = (C, TC, P, B, 1)
    rewards = rng.normal(size=shape).astype(np.float32)
    values = rng.normal(size=shape).astype(np.float32)
    dones = rng.random(shape) < 0.1
    bootstrap = rng.normal(size=(P, B, 1)).astype(np.float32)

    got = compute_advantages(0.99, 0.95, rewards, values, dones, bootstrap)
    T, N = C * TC, P * B
    want = np_gae(0.99, 0.95, rewards.reshape(T, N), values.reshape(T, N),
                  dones.reshape(T, N), bootstrap.reshape(N))
    assert got.shape == shape
    np.testing.assert_allclose(np.asarray(got).reshape(T, N), want,
                               rtol=1e-5, atol=1e-5)


def test_gae_scan_gradient():
    rng = np.random.default_rng(3)
    shape = (2, 4, 1, 8, 1)
    dones = jnp.asarray(rng.random(shape) < 0.2)
    rewards, values = (jnp.asarray(rng.normal(size=shape), jnp.float32)
                       for _ in range(2))
    boot = jnp.asarray(rng.normal(size=(1, 8, 1)), jnp.float32)
    check_grads(
        lambda r, v, b: compute_advantages(0.99, 0.95, r, v, dones, b),
        (rewards, values, boot), order=1, modes=["rev"])


# ---------------------------------------------------------------------------
# Recurrent sequence scans
# ---------------------------------------------------------------------------

def _lstm_rand(seed, T, N, H, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    xp = jnp.asarray(rng.normal(size=(T, N, 4 * H)), dtype)
    ends = jnp.asarray(rng.random((T, N, 1)) < 0.2)
    wr = jnp.asarray(rng.normal(size=(H, 4 * H)) / np.sqrt(H), dtype)
    b = jnp.asarray(rng.normal(size=(4 * H,)), dtype)
    c0 = jnp.asarray(rng.normal(size=(N, H)), dtype)
    h0 = jnp.asarray(rng.normal(size=(N, H)), dtype)
    return xp, ends, wr, b, c0, h0


def _gru_rand(seed, T, N, H, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    xp = jnp.asarray(rng.normal(size=(T, N, 3 * H)), dtype)
    ends = jnp.asarray(rng.random((T, N, 1)) < 0.2)
    wh = jnp.asarray(rng.normal(size=(H, 3 * H)) / np.sqrt(H), dtype)
    bh = jnp.asarray(rng.normal(size=(H,)), dtype)
    h0 = jnp.asarray(rng.normal(size=(N, H)), dtype)
    return xp, ends, wh, bh, h0


@pytest.mark.parametrize("T,N,H", [(5, 70, 128), (3, 512, 128), (1, 9, 128)])
def test_lstm_sequence_matches_numpy(T, N, H):
    args = _lstm_rand(10, T, N, H)
    got = lstm_sequence(*args)
    np.testing.assert_allclose(np.asarray(got), np_lstm_sequence(*args),
                               rtol=1e-5, atol=1e-5)


def test_lstm_sequence_gradient():
    xp, ends, wr, b, c0, h0 = _lstm_rand(11, 4, 6, 16)
    check_grads(
        lambda xp, wr, b, c0, h0: lstm_sequence(xp, ends, wr, b, c0, h0),
        (xp, wr, b, c0, h0), order=1, modes=["rev"])


@pytest.mark.parametrize("T,N,H", [(5, 70, 128), (3, 512, 128), (1, 9, 128)])
def test_gru_sequence_matches_numpy(T, N, H):
    args = _gru_rand(20, T, N, H)
    got = gru_sequence(*args)
    np.testing.assert_allclose(np.asarray(got), np_gru_sequence(*args),
                               rtol=1e-5, atol=1e-5)


def test_gru_sequence_gradient():
    xp, ends, wh, bh, h0 = _gru_rand(21, 4, 6, 16)
    check_grads(
        lambda xp, wh, bh, h0: gru_sequence(xp, ends, wh, bh, h0),
        (xp, wh, bh, h0), order=1, modes=["rev"])


@pytest.mark.parametrize("T,N,F,H", [(5, 70, 128, 128), (3, 260, 256, 128),
                                     (2, 9, 64, 128)])
def test_lstm_module_sequence_matches_numpy(T, N, F, H):
    """The module's sequence pass (hoisted input projection + scan) against
    the oracle fed the same projection."""
    lstm = LSTM(num_hidden_channels=H, num_layers=1, dtype=jnp.float32)
    rng = np.random.default_rng(30 + N)
    xs = jnp.asarray(rng.normal(size=(T, N, F)), jnp.float32)
    ends = jnp.asarray(rng.random((T, N, 1)) < 0.2)
    state = lstm.init_recurrent_state(N)
    params = lstm.init(jax.random.PRNGKey(0), state, xs[0], False)
    p = params["params"]["layer_0"]

    got = lstm.apply(params, state, ends, xs, False, method="sequence")
    xp = np.asarray(xs, np.float64) @ np.asarray(p["input_proj"]["kernel"],
                                                 np.float64)
    want = np_lstm_sequence(xp, ends, p["recurrent_kernel"], p["bias"],
                            state[0][:, 0], state[1][:, 0])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_recurrent_module_sequence_matches_stepwise(family):
    """The update-time sequence pass reproduces the rollout-time step loop
    with done clears (fp32, two layers)."""
    dtype = jnp.float32
    N, T, H, F = 6, 12, 128, 8
    mod = (LSTM if family == "lstm" else GRU)(
        num_hidden_channels=H, num_layers=2, dtype=dtype)

    rng = np.random.default_rng(13)
    xs = jnp.asarray(rng.normal(size=(T, N, F)), dtype)
    dones = jnp.asarray(rng.random((T, N, 1)) < 0.2)

    init_state = mod.init_recurrent_state(N)
    params = mod.init(jax.random.PRNGKey(0), init_state, xs[0], False)

    state = init_state
    outs = []
    for t in range(T):
        out, state = mod.apply(params, state, xs[t], False)
        state = mod.clear_recurrent_state(state, dones[t])
        outs.append(out)
    seq_out = mod.apply(
        params, init_state, dones, xs, False, method="sequence")
    np.testing.assert_allclose(
        np.asarray(jnp.stack(outs)), np.asarray(seq_out),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_recurrent_module_fused_matches_stepwise_bf16(family):
    """bf16 + nonzero biases: the single-step (rollout) and sequence
    (update) forwards must agree bit-for-bit — rounding-point mismatches
    (e.g. an unrounded fp32 bias on one path) only surface off-f32."""
    dtype = jnp.bfloat16
    N, T, H, F = 6, 10, 128, 8
    mod = (LSTM if family == "lstm" else GRU)(
        num_hidden_channels=H, num_layers=1, dtype=dtype)

    rng = np.random.default_rng(33)
    xs = jnp.asarray(rng.normal(size=(T, N, F)), dtype)
    dones = jnp.asarray(rng.random((T, N, 1)) < 0.2)

    init_state = mod.init_recurrent_state(N)
    params = mod.init(jax.random.PRNGKey(0), init_state, xs[0], False)
    # Nonzero biases (init is zeros, which would hide rounding bugs).
    params = jax.tree.map(
        lambda l: (jnp.asarray(
            np.random.default_rng(34).normal(size=l.shape), l.dtype)
            if l.ndim == 1 else l),
        params)

    state = init_state
    outs = []
    for t in range(T):
        out, state = mod.apply(params, state, xs[t], False)
        state = mod.clear_recurrent_state(state, dones[t])
        outs.append(out)
    stepwise = jnp.stack(outs)

    seq_out = mod.apply(
        params, init_state, dones, xs, False, method="sequence")
    np.testing.assert_array_equal(np.asarray(stepwise, np.float32),
                                  np.asarray(seq_out, np.float32))


# ---------------------------------------------------------------------------
# Entity self-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,heads,head_dim", [
    (4, 8, 2, 32), (3, 17, 4, 64), (4, 11, 2, 32), (3, 5, 4, 64),
    (2, 256, 2, 32), (1, 300, 4, 64), (3, 130, 2, 32),
])
def test_self_attention_matches_numpy(B, S, heads, head_dim):
    F = 24
    net = SelfAttention(num_heads=heads, qkv_features=heads * head_dim,
                        out_features=F, dtype=jnp.float32)
    x = jnp.asarray(np.random.default_rng(S).normal(size=(B, S, F)),
                    jnp.float32)
    params = net.init(jax.random.PRNGKey(0), x)
    got = net.apply(params, x)
    want = np_self_attention(
        x, params["params"]["MultiHeadDotProductAttention_0"])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [12, 300])
def test_self_attention_gradient(S):
    net = SelfAttention(num_heads=2, qkv_features=16, out_features=8,
                        dtype=jnp.float32)
    x = jnp.asarray(np.random.default_rng(9).normal(size=(2, S, 8)),
                    jnp.float32)
    params = net.init(jax.random.PRNGKey(0), x)
    check_grads(lambda p, x: net.apply(p, x), (params, x), order=1,
                modes=["rev"])


def test_numpy_softmax_mask_oracle():
    """The oracle's masking: masked keys get exactly zero weight."""
    s = np.random.default_rng(0).normal(size=(3, 7))
    mask = np.arange(7) < 4
    p = np_softmax(s, mask)
    assert np.all(p[:, 4:] == 0)
    np.testing.assert_allclose(p[:, :4], np_softmax(s[:, :4]))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_entity_net_rollout_and_update_pass_agree(dtype):
    """The rollout pass (train=False) and the update pass (train=True)
    compute bit-identical features, so PPO ratios start at exactly 1."""
    rng = np.random.default_rng(8)
    obs = FrozenDict({
        "self": jnp.asarray(rng.normal(size=(64, 16)), dtype),
        "allies": jnp.asarray(rng.normal(size=(64, 5, 12)), dtype),
        "enemies": jnp.asarray(rng.normal(size=(64, 6, 12)), dtype),
    })
    net = EntitySelfAttentionNet(num_embed_channels=32, num_out_channels=64,
                                 num_heads=2, dtype=dtype)
    params = net.init(jax.random.PRNGKey(0), obs, train=False)
    out = net.apply(params, obs, train=False)
    out_train = net.apply(params, obs, train=True,
                          mutable=["batch_stats"])[0]
    assert out.shape == (64, 64) and out.dtype == dtype
    np.testing.assert_array_equal(np.asarray(out_train, np.float32),
                                  np.asarray(out, np.float32))


# ---------------------------------------------------------------------------
# Layer norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layer_norm_forward(dtype):
    rng = np.random.default_rng(1)
    N, D = 300, 128
    x = jnp.asarray(rng.normal(size=(N, D)), dtype)
    params = {"params": {
        "scale": jnp.asarray(rng.normal(size=(D,)) + 1.0, jnp.float32),
        "bias": jnp.asarray(rng.normal(size=(D,)), jnp.float32)}}
    got = nn.LayerNorm(dtype=dtype).apply(params, x)
    want = np_layer_norm(x.astype(jnp.float32), params["params"]["scale"],
                         params["params"]["bias"])
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    assert got.dtype == dtype
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=tol, atol=tol)


def test_layer_norm_backward():
    rng = np.random.default_rng(2)
    N, D = 20, 64
    x = jnp.asarray(rng.normal(size=(N, D)), jnp.float32)
    params = {"params": {
        "scale": jnp.asarray(rng.normal(size=(D,)) + 1.0, jnp.float32),
        "bias": jnp.asarray(rng.normal(size=(D,)), jnp.float32)}}
    ln = nn.LayerNorm(dtype=jnp.float32)
    check_grads(lambda p, x: jnp.sin(ln.apply(p, x)), (params, x), order=1,
                modes=["rev"])


def test_layer_norm_module_param_structure_invariant():
    """The model's LayerNorm keeps its parameters at impl/{scale,bias}:
    PPO's renorm_layernorms reads those paths by name and checkpoints
    store them there."""
    x = jnp.asarray(
        np.random.default_rng(50).normal(size=(6, 128)), jnp.float32)
    params = LayerNorm(dtype=jnp.float32).init(jax.random.PRNGKey(0), x)
    assert jax.tree.map(jnp.shape, params) == {
        "params": {"impl": {"scale": (128,), "bias": (128,)}}}
    got = LayerNorm(dtype=jnp.float32).apply(params, x)
    want = np_layer_norm(x, params["params"]["impl"]["scale"],
                         params["params"]["impl"]["bias"])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_gru_two_layer_module_sequence_matches_numpy():
    """Stacked layers: layer 1 consumes layer 0's output sequence."""
    T, N, F, H = 4, 10, 12, 32
    gru = GRU(num_hidden_channels=H, num_layers=2, dtype=jnp.float32)
    rng = np.random.default_rng(40)
    xs = jnp.asarray(rng.normal(size=(T, N, F)), jnp.float32)
    ends = jnp.asarray(rng.random((T, N, 1)) < 0.2)
    state = jnp.asarray(rng.normal(size=(N, 2, H)), jnp.float32)
    params = gru.init(jax.random.PRNGKey(1), state, xs[0], False)

    got = gru.apply(params, state, ends, xs, False, method="sequence")
    layer_in, outs = np.asarray(xs, np.float64), []
    for layer in range(2):
        p = params["params"][f"layer_{layer}"]
        xp = (layer_in @ np.asarray(p["input_proj"]["kernel"], np.float64)
              + np.asarray(p["input_proj"]["bias"], np.float64))
        layer_in = np_gru_sequence(xp, ends, p["recurrent_kernel"],
                                   p["bias_h"], state[:, layer])
        outs.append(layer_in)
    np.testing.assert_allclose(np.asarray(got), np.concatenate(outs, -1),
                               rtol=1e-4, atol=1e-4)
