"""The port's placements, production mesh, traffic model and dry-run on
the CPU, against the JAX reference where it has a counterpart.

* Every parameter leaf of all ten archs, under all five ``PROFILES`` and on
  both production meshes, placed as the reference's ``param_shardings``
  places it on a ``jax.sharding.AbstractMesh`` of the same shape; every
  cache leaf as its ``cache_specs`` at ``decode_32k`` and ``long_500k``.
  The port's placements are ``DTensor`` placements over a ``DeviceMesh``
  on torch's fake process group; the reference's ``PartitionSpec`` goes
  through the same ``placements`` conversion.
* ``sharded_stage_traffic`` dict for dict equal to the reference's, and
  the exchange bytes of a real rank walk (2 and 4 gloo ranks) equal to
  its ``permute_bytes_per_chip`` (the reference's
  ``test_permute_traffic_matches_model``).
* The dry-run's flop count is per rank, and a small cell (2 x 4 mesh,
  smoke config, ``spm_dp``, train) runs end to end with every grad's
  reduction counted; a grad left partial fails its check.
"""

import dataclasses
import functools
import multiprocessing

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.core.eligibility import plan_steps  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import (fake_process_group,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.transformer import stack_key  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
SAME_HW = {"peak_flops": 1e15, "hbm_bw": 3e12, "ici_bw": 4e11,
           "link_bw": 4e11}


def _ref_modules():
    import jax
    from jax.sharding import AbstractMesh
    from repro.launch import hlo_analysis as J_H
    from repro.launch import specs as J_S
    from repro.parallel import sharding as J_SH
    return jax, AbstractMesh, J_H, J_S, J_SH


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """The port's abstract params and caches and the reference's, made
    once for both meshes."""
    _, _, _, J_S, _ = _ref_modules()
    from repro import configs as J_C
    cfg, jcfg = C.get_config(arch), J_C.get_config(arch)
    caches = {}
    for shape in (C.SHAPES["decode_32k"], C.SHAPES["long_500k"]):
        caches[shape.name] = (
            S.abstract_cache(cfg, shape.global_batch, shape.seq_len),
            J_S.abstract_cache(jcfg, shape.global_batch, shape.seq_len))
    return (S.abstract_params(cfg), J_S.abstract_state(jcfg)["params"],
            caches)


def _spec(named, ndim):
    """A reference ``NamedSharding``'s spec as a tuple of ``ndim``
    entries."""
    spec = tuple(named.spec)
    return spec + (None,) * (ndim - len(spec))


def _ref_path_specs(jax, tree, shardings):
    """``{path: (spec, shape)}`` over a reference tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = jax.tree_util.tree_leaves(shardings)
    out = {}
    for (path, leaf), sh in zip(leaves, shs):
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join(parts)] = (_spec(sh, leaf.ndim), tuple(leaf.shape))
    return out


@pytest.mark.parametrize("mesh_kind", tuple(MESHES))
def test_param_and_cache_placements_match_the_reference(mesh_kind):
    jax, AbstractMesh, _, _, J_SH = _ref_modules()
    dims, axes = MESHES[mesh_kind]
    jmesh = AbstractMesh(dims, axes)
    n_leaves = 0
    with fake_process_group(int(np.prod(dims))):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
        for arch in C.ARCH_IDS:
            cfg = C.get_config(arch)
            params, jparams, caches = _trees(arch)
            key = stack_key(cfg)
            for profile in SH.PROFILES:
                got = SH.param_shardings(mesh, params, profile, cfg=cfg)
                ref = _ref_path_specs(
                    jax, jparams, J_SH.param_shardings(jmesh, jparams,
                                                       profile))
                assert len(got) == sum(1 for _ in params.parameters())
                for name, pl in got.items():
                    spec, shape = ref[SH.tree_path_str(key(name))]
                    if key(name) != name:          # a stacked reference leaf
                        assert spec[0] is None
                        spec = spec[1:]
                    assert pl == SH.placements(spec, mesh), \
                        (arch, profile, name, pl, spec)
                    n_leaves += 1
            for shape in (C.SHAPES["decode_32k"], C.SHAPES["long_500k"]):
                cache, jcache = caches[shape.name]
                got = SH.cache_specs(mesh, cache,
                                     seq_sharded=shape.seq_sharded)
                ref = _ref_path_specs(
                    jax, jcache, J_SH.cache_specs(
                        jmesh, jcache, seq_sharded=shape.seq_sharded))
                stacked = isinstance(jcache, dict)
                g = len(jcache) if stacked else 0
                for i, layer in enumerate(got):
                    for part, leaves in layer.items():
                        for leaf, pl in leaves.items():
                            path = (f"l{i % g}/{part}/{leaf}" if stacked
                                    else f"{i}/{part}/{leaf}")
                            spec, _ = ref[path]
                            if stacked:
                                assert spec[0] is None
                                spec = spec[1:]
                            assert pl == SH.placements(spec, mesh), \
                                (arch, shape.name, path, pl, spec)
    assert n_leaves > 5000


def test_placements_of_a_tuple_of_axes():
    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True)
        from torch.distributed.tensor import Replicate, Shard
        pl = SH.placements((("pod", "data", "model"), None), mesh)
        assert pl == (Shard(0), Shard(0), Shard(0))
        pl = SH.placements((None, "data", "model"), mesh)
        assert pl == (Replicate(), Shard(1), Shard(2))
        pl = SH.placements((("pod", "data"), None), mesh)
        assert pl == (Shard(0), Shard(0), Replicate())
        with pytest.raises(ValueError):
            SH.placements((("data", "pod"),), mesh)      # out of mesh order
        with pytest.raises(ValueError):
            SH.placements(("data", "data"), mesh)
        assert SH.data_axes(mesh) == ("pod", "data")
        assert SH.batch_spec(mesh) == (("pod", "data"),)
        assert SH.batch_spec(mesh, seq_sharded=True) == (("pod",), "data")


def test_make_production_mesh_under_the_fake_group_and_without():
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="fake_process_group"):
        make_production_mesh()
    for multi, n in ((False, 256), (True, 512)):
        with fake_process_group(n):
            mesh = make_production_mesh(multi_pod=multi)
            dims, axes = MESHES["multi" if multi else "single"]
            assert tuple(mesh.shape) == dims
            assert mesh.mesh_dim_names == axes
            assert mesh.get_group("model").size() == 16
            with pytest.raises(RuntimeError, match=str(768 - n)):
                make_production_mesh(multi_pod=not multi)
    assert not dist.is_initialized()


def _traffic_cases():
    out = []
    for n, L, shards in ((64, 8, 8), (64, 6, 4), (2048, 11, 16),
                         (6144, 13, 4), (96, 7, 2)):
        from repro_torch.core.pairings import two_level_schedule
        strides = two_level_schedule(n, L, shards).strides()
        out.append((n, shards, plan_steps(n, strides, shards)))
    return out


def test_sharded_stage_traffic_equals_the_reference():
    _, _, J_H, _, _ = _ref_modules()
    from repro.core.eligibility import plan_steps as j_plan_steps
    from repro.core.pairings import two_level_schedule as j_two_level
    kws = ({}, {"use_diag": True, "use_bias": True, "in_width": 50,
                "out_width": 40},
           {"use_diag": True, "fold_boundaries": False, "out_width": 40},
           {"n_row_blocks": 3})
    for n, shards, steps in _traffic_cases():
        L = sum(len(s[2]) if s[0] == "local" else 1 for s in steps)
        j_steps = j_plan_steps(n, j_two_level(n, L, shards).strides(),
                               shards)
        assert tuple(steps) == tuple(j_steps)
        for overlap in (False, True):
            for kw in kws:
                for rows, dt in ((16, 4), (4096, 2)):
                    got = H.sharded_stage_traffic(
                        n // shards, rows, steps, dt, dict(SAME_HW),
                        overlap=overlap, **kw)
                    want = J_H.sharded_stage_traffic(
                        n // shards, rows, j_steps, dt, dict(SAME_HW),
                        overlap=overlap, **kw)
                    assert got == want, (n, shards, overlap, kw)


def test_roofline_terms_and_collective_bytes():
    terms = H.roofline_terms(989e12, 3.35e12, 0.0)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(1.0)
    assert terms["dominant"] in ("compute_s", "memory_s")
    assert H.roofline_terms(0, 0, 450e9)["dominant"] == "collective_s"
    got = H.collective_bytes([("all-reduce", 8), ("all-gather", 4),
                              ("all-reduce", 2),
                              ("collective-permute", 16)])
    assert got == {"all-reduce": 10, "all-gather": 4, "reduce-scatter": 0,
                   "all-to-all": 0, "collective-permute": 16, "total": 30}
    with pytest.raises(ValueError):
        H.collective_bytes([("broadcast", 1)])


def test_flops_are_counted_on_the_ranks_own_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.dryrun import _Recorder
    m, k, n = 4096, 2048, 6144
    glob = 2 * m * k * n
    with fake_process_group(256):
        mesh = make_production_mesh()
        with FakeTensorMode():
            def dt(shape, pl):
                return distribute_tensor(torch.empty(shape), mesh, pl,
                                         src_data_rank=None)
            a = dt((m, k), [Shard(0), Replicate()])
            b = dt((k, n), [Replicate(), Shard(1)])
            ar = dt((m, k), [Replicate(), Replicate()])
            br = dt((k, n), [Replicate(), Replicate()])
            rec = _Recorder()
            with rec:
                y = a @ b
            assert tuple(y.placements) == (Shard(0), Shard(1))
            assert rec.flops == glob // 256 and not rec.records
            rec = _Recorder()
            with rec:
                ar @ br
            assert rec.flops == glob


def _small_cell(**kw):
    from repro_torch.launch import dryrun as D
    return D.run_cell("qwen3-1.7b", "train_4k", "single", save=False,
                      profile="spm_dp", cfg=C.get_smoke("qwen3-1.7b"),
                      mesh_shape=(2, 4),
                      shape=ShapeSpec("train_small", 16, 16, "train"), **kw)


def test_a_small_cell_end_to_end_counts_every_grad_reduction():
    from torch.distributed.tensor import Replicate
    rec = _small_cell()
    assert rec["ok"], rec.get("error")
    assert rec["n_chips"] == 8 and rec["mesh_shape"] == [2, 4]
    assert rec["memory"]["state_bytes"] > 0
    assert rec["memory"]["peak_bytes"] > rec["memory"]["state_bytes"]
    assert rec["cost"]["flops"] > 0
    assert rec["model"]["tokens"] == 16 * 16
    # the grads' reduction, reckoned from the placements alone: a grad
    # arrives partial over some mesh dims (the batch's, unless the backward
    # reduced it already); each is, in mesh order, all-reduced where its
    # parameter is replicated and reduce-scattered where it is split
    cfg = dataclasses.replace(C.get_smoke("qwen3-1.7b"), embed_onehot=True)
    with fake_process_group(8):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        params = S.abstract_params(cfg)
        pls = SH.param_shardings(mesh, params, "spm_dp", cfg=cfg)
    want = {"all-reduce": 0, "reduce-scatter": 0}
    n_partial = 0
    for name, p in params.named_parameters():
        size = p.numel() * p.element_size()
        mine = []
        for m, pl in enumerate(pls[name]):
            split = pl != Replicate()
            if m in rec["grads"][name]["partial_dims"]:
                kind = "reduce-scatter" if split else "all-reduce"
                size //= (2, 4)[m] if split else 1
                mine.append((kind, size))
            elif split:
                size //= (2, 4)[m]
        for kind, nbytes in mine:
            want[kind] += nbytes
        assert [tuple(c) for c in rec["grads"][name]["collectives"]] == mine
        n_partial += bool(mine)
    assert n_partial > len(pls) // 2
    got = rec["grad_collectives"]
    assert {k: got[k] for k in want} == want
    assert got["total"] == sum(want.values())
    assert rec["collectives"]["all-reduce"] >= want["all-reduce"]


def test_a_grad_left_partial_fails_the_cell():
    rec = _small_cell(skip_grad="layers.1.mlp.down.mix")
    assert not rec["ok"]
    assert "layers.1.mlp.down.mix" in rec["error"]
    assert "partial" in rec["error"]


def test_a_cell_past_its_limit_is_recorded_as_failed():
    import torch.distributed as dist
    rec = _small_cell(limit_s=0.5)
    assert not rec["ok"] and rec["error"].startswith("TimeoutError")
    assert not dist.is_initialized()

# ---------------------------------------------------------------------------
# the exchange bytes of a real rank walk
# ---------------------------------------------------------------------------

ROWS, N, L = 12, 64, 6


def _exchange_job(pod):
    """One step-serial forward of the rank executor: this rank's exchange
    calls and bytes, and the plan's steps."""
    from repro_torch.core import spm as T_spm
    from repro_torch.launch.mesh import make_feature_rank_mesh
    from repro_torch.parallel import activation_sharding
    mesh = make_feature_rank_mesh(pod.size, "cpu")
    cfg = T_spm.SPMConfig(n=N, n_stages=L, schedule="two_level",
                          n_shards=pod.size, backward="custom",
                          use_kernel=False, use_diag=False, use_bias=False)
    p = T_spm.init_spm(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (ROWS, N)).astype(np.float32))
    with activation_sharding(mesh, shard_feature=True):
        T_spm.spm_apply(p, x, cfg)
    return {"calls": mesh.stats["exchange_calls"],
            "bytes": mesh.stats["exchange_bytes"],
            "steps": plan_steps(N, cfg.pairing.strides(), pod.size)}


if multiprocessing.parent_process() is None:
    from repro_torch.launch.mesh import run_ranks


@pytest.mark.parametrize("n_ranks", (2, 4))
def test_rank_walk_exchange_bytes_equal_the_traffic_model(n_ranks):
    out = run_ranks(n_ranks, _exchange_job, device="cpu", threads=1,
                    timeout_s=300)
    steps = out[0]["steps"]
    model = H.sharded_stage_traffic(N // n_ranks, ROWS, steps,
                                    dtype_bytes=4)
    n_cross = sum(1 for s in steps if s[0] == "cross")
    assert n_cross >= 1
    for r in out:
        assert r["bytes"] == model["permute_bytes_per_chip"]
        assert r["calls"] == n_cross

