"""The in-repo module layer, pytree dataclasses, FrozenDict and loss scaler
against flax as the oracle (flax is a test-only dependency).

Each module family is built twice, once on ``madrona_learn_tpu.nn`` and
once on ``flax.linen``, from the same source; parameter trees must match in
structure and value, and outputs must match, in float32 and bfloat16.
"""

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

flax = pytest.importorskip("flax")
from flax import linen as fnn  # noqa: E402
from flax.core import FrozenDict as FlaxFrozenDict  # noqa: E402
from flax.training.dynamic_scale import (  # noqa: E402
    DynamicScale as FlaxDynamicScale)

from madrona_learn_tpu import nn  # noqa: E402
from madrona_learn_tpu.ops.loss_scale import DynamicScale  # noqa: E402
from madrona_learn_tpu.struct import (  # noqa: E402
    FrozenDict, PyTreeNode, field, freeze, unfreeze)

def _families(lib, dtype):
    """name -> (module, example input builder) on module library ``lib``."""
    compact = lib.compact

    class Stack(lib.Module):
        width: int
        depth: int

        @compact
        def __call__(self, x):
            for _ in range(self.depth):
                x = lib.Dense(self.width, use_bias=False, dtype=dtype,
                              kernel_init=jax.nn.initializers.orthogonal())(x)
                x = jax.nn.relu(lib.LayerNorm(dtype=dtype)(x))
            return x

    class Cells(lib.Module):
        def setup(self):
            self.cells = [lib.Dense(8, dtype=dtype, name=f"layer_{i}")
                          for i in range(2)]
            self.extra = [lib.Dense(4, dtype=dtype) for _ in range(2)]
            self.w = self.param("w", jax.nn.initializers.normal(), (8,))

        def __call__(self, x):
            for c in self.cells:
                x = c(x) * self.w.astype(x.dtype)
            return [e(x) for e in self.extra]

    class Head(lib.Module):
        @compact
        def __call__(self, x):
            return lib.Dense(3, dtype=dtype)(x)

    class Heads(lib.Module):
        heads: Dict[str, lib.Module]
        trunk: lib.Module

        @compact
        def __call__(self, x):
            x = self.trunk(x)
            return {k: h(x) for k, h in self.heads.items()}

    class Attn(lib.Module):
        @compact
        def __call__(self, x):
            return lib.MultiHeadDotProductAttention(
                num_heads=2, qkv_features=16, out_features=12,
                dtype=dtype)(x)

    class Step(lib.Module):
        @compact
        def __call__(self, carry, x):
            h = jnp.tanh(lib.Dense(6, dtype=dtype, name="inp")(x)
                         + lib.Dense(6, use_bias=False, dtype=dtype,
                                     name="rec")(carry))
            return h, h

    class Scanned(lib.Module):
        def setup(self):
            self.step = Step()

        def __call__(self, h0, xs):
            if lib is fnn:
                scan = fnn.scan(lambda m, c, x: m(c, x),
                                variable_broadcast="params",
                                split_rngs={"params": False})
                return scan(self.step, h0, xs)[1]
            if self.is_initializing():
                self.step(h0, xs[0])
            return jax.lax.scan(lambda c, x: self.step(c, x), h0, xs)[1]

    class Remat(lib.Module):
        trunk: lib.Module

        def __call__(self, x):
            if self.is_initializing():
                return self.trunk(x)
            if lib is fnn:
                return fnn.remat(lambda m, x: m(x))(self.trunk, x)
            return jax.checkpoint(lambda x: self.trunk(x))(x)

    rng = np.random.default_rng(0)

    def arr(*shape):
        return jnp.asarray(rng.normal(size=shape), dtype)

    return {
        "dense": (lib.Dense(5, dtype=dtype), (arr(4, 7),)),
        "dense_no_bias": (lib.Dense(5, use_bias=False, dtype=dtype),
                          (arr(2, 3, 7),)),
        "layer_norm": (lib.LayerNorm(dtype=dtype), (arr(4, 16),)),
        "compact_stack": (Stack(width=16, depth=3), (arr(4, 9),)),
        "setup_lists": (Cells(), (arr(4, 8),)),
        "dict_field": (Heads(heads={"a": Head(), "b": Head()},
                             trunk=Stack(width=8, depth=1)), (arr(4, 5),)),
        "attention": (Attn(), (arr(3, 2, 7, 12),)),
        "scan": (Scanned(), (arr(4, 6), arr(5, 4, 3))),
        "remat": (Remat(trunk=Stack(width=8, depth=2)), (arr(4, 5),)),
    }


FAMILIES = ["dense", "dense_no_bias", "layer_norm", "compact_stack",
            "setup_lists", "dict_field", "attention", "scan", "remat"]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_module_family_matches_flax(family, dtype):
    ours, args = _families(nn, dtype)[family]
    theirs, _ = _families(fnn, dtype)[family]
    key = jax.random.PRNGKey(7)

    p_ours = ours.init(key, *args)
    p_theirs = theirs.init(key, *args)
    assert jax.tree.structure(p_ours) == jax.tree.structure(p_theirs)
    jax.tree.map(np.testing.assert_array_equal, p_ours, p_theirs)

    out_ours = ours.apply(p_theirs, *args)
    out_theirs = theirs.apply(p_theirs, *args)
    tol = 1e-6 if dtype == jnp.float32 else 1e-2
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b, np.float32),
            rtol=tol, atol=tol),
        out_ours, out_theirs)

    if family == "remat":
        loss = lambda m: lambda p: jnp.sum(
            m.apply(p, *args).astype(jnp.float32) ** 2)
        g_ours = jax.grad(loss(ours))(p_theirs)
        g_theirs = jax.grad(loss(theirs))(p_theirs)
        # Gradients are compared against each leaf's scale: two separately
        # fused bf16 backward passes differ by a few bf16 ulps (2^-8).
        gtol = 1e-5 if dtype == jnp.float32 else 2e-2
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=gtol,
                atol=gtol * max(1.0, float(np.abs(np.asarray(b)).max()))),
            g_ours, g_theirs)


def test_apply_method_and_mutable():
    class M(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(2)(x)

        def twice(self, x):
            return 2 * self(x)

    m = M()
    x = jnp.ones((1, 3))
    variables = {"params": m.init(jax.random.PRNGKey(0), x)["params"],
                 "batch_stats": {}}
    y = m.apply(variables, x)
    np.testing.assert_array_equal(m.apply(variables, x, method="twice"),
                                  2 * y)
    np.testing.assert_array_equal(m.apply(variables, x, method=M.twice),
                                  2 * y)
    out, mutated = m.apply(variables, x, mutable=["batch_stats"])
    np.testing.assert_array_equal(out, y)
    assert mutated == {"batch_stats": {}}
    fake_out, variables2 = m.init_with_output(jax.random.PRNGKey(0), x)
    np.testing.assert_array_equal(fake_out, y)
    assert jax.tree.structure(variables2) == jax.tree.structure(
        {"params": variables["params"]})


def test_is_initializing_variables_and_unbound_errors():
    seen = []

    class M(nn.Module):
        @nn.compact
        def __call__(self, x):
            y = nn.Dense(2, name="d")(x)
            seen.append((self.is_initializing(),
                         sorted(self.variables["params"])))
            return y

    m = M()
    x = jnp.ones((1, 3))
    params = m.init(jax.random.PRNGKey(0), x)
    m.apply(params, x)
    assert seen == [(True, ["d"]), (False, ["d"])]
    with pytest.raises(ValueError, match="not bound"):
        m(x)
    with pytest.raises(KeyError, match="d/bias"):
        m.apply({"params": {"d": {"kernel": jnp.ones((3, 2))}}}, x)


class _Ours(PyTreeNode):
    b: jax.Array
    a: jax.Array
    tag: str = field(pytree_node=False, default="x")


class _Theirs(flax.struct.PyTreeNode):
    b: jax.Array
    a: jax.Array
    tag: str = flax.struct.field(pytree_node=False, default="x")


def test_pytree_node_matches_flax_struct():
    ours, theirs = _Ours(b=1.0, a=2.0), _Theirs(b=1.0, a=2.0)
    assert jax.tree.leaves(ours) == jax.tree.leaves(theirs) == [1.0, 2.0]
    paths = lambda t: [jax.tree_util.keystr(p) for p, _ in
                       jax.tree_util.tree_flatten_with_path(t)[0]]
    assert paths(ours) == paths(theirs) == [".b", ".a"]
    r = ours.replace(a=5.0)
    assert (r.a, r.b, r.tag) == (5.0, 1.0, "x")
    assert jax.tree.structure(ours) != jax.tree.structure(
        ours.replace(tag="y"))
    with pytest.raises(AttributeError):
        ours.a = 3.0
    doubled = jax.jit(lambda t: jax.tree.map(lambda v: 2 * v, t))(ours)
    assert float(doubled.a) == 4.0 and doubled.tag == "x"


NESTED = {"z": 1.0, "a": {"y": 2.0, "b": {"c": 3.0}}, "m": (4.0, 5.0)}


@pytest.mark.parametrize("tree", [NESTED, {}, {"only": 1.0}])
def test_frozen_dict_flattens_like_flax(tree):
    ours, theirs = FrozenDict(tree), FlaxFrozenDict(tree)
    lo, to = jax.tree_util.tree_flatten_with_path(ours)[0], \
        jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [(jax.tree_util.keystr(p), v) for p, v in lo] == \
        [(jax.tree_util.keystr(p), v) for p, v in to]
    # Same layout as the plain nested dict, so checkpoints are unchanged.
    assert jax.tree.leaves(ours) == jax.tree.leaves(tree)
    assert unfreeze(ours) == theirs.unfreeze() == tree
    rebuilt = jax.tree.unflatten(jax.tree.structure(ours),
                                 jax.tree.leaves(ours))
    assert unfreeze(rebuilt) == tree


def test_frozen_dict_methods_match_flax():
    ours, theirs = freeze(NESTED), FlaxFrozenDict(NESTED)
    assert isinstance(ours["a"], FrozenDict)
    assert unfreeze(ours["a"]) == theirs["a"].unfreeze()
    assert unfreeze(ours.copy({"n": 6.0, "z": 0.0})) == \
        theirs.copy({"n": 6.0, "z": 0.0}).unfreeze()
    rest, val = ours.pop("a")
    rest_t, val_t = theirs.pop("a")
    assert unfreeze(rest) == rest_t.unfreeze()
    assert unfreeze(val) == val_t.unfreeze()
    assert ours.get("missing", 9) == 9 and "z" in ours and len(ours) == 3
    assert hash(freeze({"k": 1})) == hash(freeze({"k": 1}))
    assert freeze({"k": 1}) == freeze({"k": 1})
    with pytest.raises(TypeError):
        ours["z"] = 2.0


def test_dynamic_scale_matches_flax():
    """Backoff on an fp16 overflow and growth after growth_interval finite
    steps follow flax's rule step for step."""
    x = jnp.linspace(0.1, 1.0, 16, dtype=jnp.float32)

    def loss(w, boost):
        y = jnp.asarray(w * x * boost, jnp.float16) ** 2
        return jnp.mean(y.astype(jnp.float32))

    ours = DynamicScale(growth_interval=2, fin_steps=jnp.int32(0),
                        scale=jnp.float32(1024.0))
    theirs = FlaxDynamicScale(growth_interval=2, fin_steps=jnp.int32(0),
                              scale=jnp.float32(1024.0))
    w = jnp.float32(0.7)
    scales = [1024.0]
    for boost in [1.0, 1e6, 1.0, 1.0, 1.0, 1.0]:
        ours, fin_o, val_o, g_o = ours.value_and_grad(
            lambda w: loss(w, boost))(w)
        theirs, fin_t, val_t, g_t = theirs.value_and_grad(
            lambda w: loss(w, boost))(w)
        assert bool(fin_o) == bool(fin_t)
        assert float(ours.scale) == float(theirs.scale)
        assert int(ours.fin_steps) == int(theirs.fin_steps)
        if bool(fin_t):
            np.testing.assert_array_equal(val_o, val_t)
            np.testing.assert_array_equal(g_o, g_t)
        scales.append(float(ours.scale))
    steps = np.diff(scales)
    assert (steps < 0).any() and (steps > 0).any()  # backoff and growth


def test_compact_children_reuse_params_across_calls():
    """A compact method called twice (as in a scan body) names its
    children the same way each time, so the second call reads the
    parameters the first created; modules built in setup() belong to
    their owner, not to a compact caller."""
    class Inner(nn.Module):
        def setup(self):
            self.proj = nn.Dense(3, name="proj")

        def __call__(self, x):
            return self.proj(x)

    class Outer(nn.Module):
        @nn.compact
        def __call__(self, x):
            a = nn.Dense(3)(x)
            return Inner()(a) + nn.Dense(3)(x)

        def twice(self, x):
            return self(x) + self(x)

    m = Outer()
    x = jnp.ones((2, 3))
    params = m.init(jax.random.PRNGKey(0), x, method="twice")
    assert jax.tree.map(jnp.shape, params) == {"params": {
        "Dense_0": {"kernel": (3, 3), "bias": (3,)},
        "Dense_1": {"kernel": (3, 3), "bias": (3,)},
        "Inner_0": {"proj": {"kernel": (3, 3), "bias": (3,)}}}}
    np.testing.assert_array_equal(m.apply(params, x, method="twice"),
                                  2 * m.apply(params, x))


def test_modules_hash_and_compare_by_fields():
    a = nn.Dense(4, dtype=jnp.bfloat16)
    assert a == nn.Dense(4, dtype=jnp.bfloat16)
    assert hash(a) == hash(nn.Dense(4, dtype=jnp.bfloat16))
    assert a != nn.Dense(5, dtype=jnp.bfloat16)


def test_frozen_dict_pickles():
    import pickle

    fd = freeze(NESTED)
    back = pickle.loads(pickle.dumps(fd))
    assert isinstance(back, FrozenDict) and unfreeze(back) == NESTED
