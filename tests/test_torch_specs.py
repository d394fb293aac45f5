"""The port's cell registry and abstract specs on the CPU, against the JAX
reference: the (arch x shape) cells in the reference's order, every
cell's input specs, the abstract params, train state and decode cache of
all ten archs at full width and at smoke size (the port's on torch's
``meta`` device, the reference's from ``jax.eval_shape``), the parameter
counts, the one-hot embedding lookup, and the placement hints' identity
outside a device mesh.

The reference's stacked trees are unstacked through the mapping that
``convert.params_from_jax`` uses (``convert.unstack_layers``) and compared
leaf for leaf, shape and dtype, in the reference's flatten order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as J_C  # noqa: E402
from repro.launch import specs as J_S  # noqa: E402
from repro.layers.embedding import EmbeddingConfig as JEmbCfg  # noqa: E402
from repro.layers.embedding import embed as j_embed  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import unstack_layers  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.layers.embedding import EmbeddingConfig, embed  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import ctx as par_ctx  # noqa: E402
from repro_torch.train.state import tree_leaves_with_path  # noqa: E402

DECODE = C.SHAPES["decode_32k"]


def _dtype(d) -> str:
    """A dtype's numpy-style name, for either side."""
    return str(d).replace("torch.", "")


def _ref_leaves(tree):
    """``[(path, shape, dtype)]`` of a reference tree in its flatten
    order."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out.append(("/".join(parts), tuple(leaf.shape), _dtype(leaf.dtype)))
    return out


def _port_leaves(tree):
    return [("/".join(str(p) for p in path), tuple(t.shape), _dtype(t.dtype))
            for path, t in tree_leaves_with_path(tree)]


def _take(tree, i):
    """Row i of every leaf of a stacked shape tree: the leading group axis
    dropped (``convert.unstack_layers``'s ``take``)."""
    return jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype), tree)


def _unstacked(tree: dict, n_layers: int) -> dict:
    out = dict(tree)
    out["layers"] = unstack_layers(tree["layers"], n_layers, _take)
    return out


def _cfgs(arch):
    return ((J_C.get_config(arch), C.get_config(arch)),
            (J_C.get_smoke(arch), C.get_smoke(arch)))


def test_cells_and_shapes_match_the_reference():
    assert C.ARCH_IDS == J_C.ARCH_IDS
    assert C.LM_SHAPES == J_C.LM_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in C.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_C.SHAPES.items()}
    cells = [(a, dataclasses.asdict(s), ok) for a, s, ok in C.all_cells()]
    want = [(a, dataclasses.asdict(s), ok) for a, s, ok in J_C.all_cells()]
    assert cells == want
    for arch in C.ARCH_IDS:
        assert C.is_subquadratic(arch) == J_C.is_subquadratic(arch)
        assert [s.name for s in C.arch_shapes(arch)] == \
            [s.name for s in J_C.arch_shapes(arch)]
    # 10 archs x 3 shapes, and long_500k for the three sub-quadratic ones
    assert sum(len(C.arch_shapes(a)) for a in C.ARCH_IDS) == 33


def test_overlap_knob_of_get_config():
    for arch in ("qwen3-1.7b", "qwen3-moe-30b-a3b"):
        for on in (True, False, None):
            assert C.get_config(arch, overlap=on).spm_overlap is on
            assert C.get_smoke(arch, overlap=on).spm_overlap is on
            assert J_C.get_config(arch, overlap=on).spm_overlap is on
        assert C.get_config(arch, use_kernel=False, overlap=True) \
            .spm_use_kernel is False


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    for (jc, tc) in _cfgs(arch):
        for shape in C.SHAPES.values():
            got = S.input_specs(tc, shape)
            want = J_S.input_specs(jc, J_C.SHAPES[shape.name])
            assert list(got) == list(want), (arch, shape.name)
            for k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape), k
                assert _dtype(got[k].dtype) == _dtype(want[k].dtype), k


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_abstract_params_state_and_cache_match_the_reference(arch):
    for jc, tc in _cfgs(arch):
        n = tc.n_layers
        j_state = J_S.abstract_state(jc)     # its params: abstract_params'
        j_params = j_state["params"]
        t_params = S.abstract_params(tc)
        assert all(p.device.type == "meta" for p in t_params.parameters())
        assert _port_leaves(t_params) == _ref_leaves(_unstacked(j_params, n))

        t_state = S.abstract_state(tc)
        want = dict(j_state)
        want["params"] = _unstacked(j_state["params"], n)
        want["opt"] = {"mu": _unstacked(j_state["opt"]["mu"], n),
                       "nu": _unstacked(j_state["opt"]["nu"], n),
                       "count": j_state["opt"]["count"]}
        assert _port_leaves(t_state) == _ref_leaves(want)

        j_cache = J_S.abstract_cache(jc, DECODE.global_batch,
                                     DECODE.seq_len)
        t_cache = S.abstract_cache(tc, DECODE.global_batch, DECODE.seq_len)
        want = unstack_layers(j_cache, n, _take)
        assert _port_leaves(t_cache) == _ref_leaves(want)
        assert T.model_param_count(t_params) == \
            J_T.model_param_count(j_params)


def test_model_param_count_counts_a_real_tree():
    cfg = C.get_smoke("qwen3-1.7b")
    params = T.init_model(cfg, device="cpu")
    assert T.model_param_count(params) == sum(
        p.numel() for p in params.parameters())
    assert T.model_param_count(params) == T.model_param_count(
        S.abstract_params(cfg))


def test_embed_onehot_equals_the_gather_and_the_reference_grad():
    rng = np.random.default_rng(27)
    V, d = 97, 24
    table = rng.standard_normal((V, d)).astype(np.float32)
    tokens = rng.integers(0, V, size=(3, 11)).astype(np.int64)
    tokens[0, :3] = 5                      # a repeated token's rows sum
    cfg = EmbeddingConfig(vocab_size=V, d_model=d)
    for dt in (torch.float32, torch.bfloat16):
        p = {"table": torch.from_numpy(table)}
        tok = torch.from_numpy(tokens)
        a = embed(p, tok, cfg, dt, onehot=True)
        b = embed(p, tok, cfg, dt)
        assert a.dtype == b.dtype == dt
        assert torch.equal(a, b)
    # the grad of a weighted sum, against the reference's on the same data
    w = rng.standard_normal((3, 11, d)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_(True)
    out = embed({"table": t}, torch.from_numpy(tokens), cfg, onehot=True)
    (out * torch.from_numpy(w)).sum().backward()
    jcfg = JEmbCfg(vocab_size=V, d_model=d)
    g_ref = jax.grad(lambda tb: jnp.sum(j_embed(
        {"table": tb}, jnp.asarray(tokens), jcfg, jnp.float32,
        onehot=True) * w))(jnp.asarray(table))
    # each row sums its token's rows of w, in another order on each side:
    # within one rounding of the sum of their magnitudes
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_ref),
                               rtol=0, atol=2 * np.finfo(np.float32).eps
                               * np.abs(w).sum(axis=(0, 1)).max())
    rows = set(tokens.ravel().tolist())
    dead = [r for r in range(V) if r not in rows]
    assert not t.grad[dead].any()


def test_placement_hints_are_the_identity_without_a_device_mesh():
    x = torch.randn(2, 3, 4, 5)
    for kind in ("heads", "kv_heads", "btd", "batch_full", "feature"):
        assert par_ctx.constrain(x, kind) is x
    with par_ctx.activation_sharding(par_ctx.make_feature_mesh(
            2, device="cpu"), shard_feature=True):
        for kind in ("heads", "kv_heads", "btd", "batch_full", "feature"):
            assert par_ctx.constrain(x, kind) is x
    with pytest.raises(ValueError):
        par_ctx.constrain(x, "rows")
    assert par_ctx.whole_features(x) is x
    assert par_ctx.whole_features(x, 1, 2) is x
    assert par_ctx.reduced(x) is x
    assert par_ctx.placements_of(x) is None
    assert par_ctx.placed_as(x, None) is x
    params = T.init_model(C.get_smoke("qwen3-1.7b"), device="cpu")
    q = params["layers"][0]["mixer"]["q"]
    assert par_ctx.whole_params(q) is q
