"""The reference's large dense decoders on the port, on the CPU.

chatglm3-6b, granite-8b, internlm2-20b and chameleon-34b serve at d 4096
to 8192, past the 2048 columns one portable cluster of the tensor-core
``linked_mlp`` kernel covers.  Here:

* ``mlp_plan`` sends every registered decoder's bf16 SwiGLU width to the
  tensor-core kernel at decode, a 32-token chunk of 8 slots and batched
  prefill (``slots=`` standing in for the occupancy calculator), fp32 to
  the FFMA kernel, and ``path="tc"`` still raises for what the kernel
  refuses; ``tc_columns``, the kernel's column ownership, covers
  ``[0, d)`` once at each width and at ragged ones;
* the plain version matches the reference's Pallas kernel (interpret
  mode) at d 4096, 6144 and 8192;
* 2-layer configs that keep each arch's head structure (q / kv heads,
  ``rope_fraction``, ``qk_norm``) at head_dim 16 match the reference's
  prefill, chunk and decode logits under teacher forcing (rtol 3e-4);
* ``Model.init(dtype=)``, the serving init, is bit-equal to
  ``cast_params(init())`` and consumes the generator as it does.

The kernels themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 2 and 3h).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.kernels.linked_matmul import linked_matmul as ref_lm
from repro.models.model import Model as JaxModel
from repro_torch import kernels
from repro_torch.configs.base import ModelConfig, all_configs, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.pipeline import KernelPlan
from repro_torch.kernels.linked_matmul import ops as lm
from repro_torch.launch import serve
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import Model

from test_torch_model import RTOL, _run_port, _run_ref, _script
from test_torch_recurrent import _per_layer_fan_in

LARGE = ("chatglm3-6b", "granite-8b", "internlm2-20b", "chameleon-34b")
#: every registered SwiGLU site's bf16 (d, ff): the dense and hybrid
#: decoders' MLPs and arctic-480b's dense residual
SWIGLU_WIDTHS = {(2048, 6144), (1152, 6912), (1600, 5504), (4096, 13696),
                 (4096, 14336), (6144, 16384), (7168, 4864), (8192, 22016)}
#: ownership edges: one column block past 2048; widths no cluster's
#: 256-column ranks divide
RAGGED_D = (2056, 4104, 6152, 8200)
#: a stand-in for the occupancy calculator on a 132-SM H100: one CTA an
#: SM, clusters within a GPC, 7 of the non-portable sizes
H100_SLOTS = {1: 132, 2: 66, 3: 44, 4: 32, 5: 26, 6: 22, 7: 18, 8: 15}


def _slots(cl):
    return H100_SLOTS.get(cl, 7)


def _swiglu_sites():
    out = set()
    for cfg in all_configs().values():
        if cfg.family == "moe":
            if cfg.moe_dense_residual:
                out.add((cfg.d_model, cfg.d_ff))
        elif cfg.d_ff and cfg.family != "audio":
            out.add((cfg.d_model, cfg.d_ff))
    return out


def test_registry_swiglu_widths():
    """The widths below are every registered SwiGLU site's, all bf16."""
    assert _swiglu_sites() == SWIGLU_WIDTHS
    assert all(c.dtype == "bfloat16" for c in all_configs().values())


@pytest.mark.parametrize("M", [8, 256, 4352])
@pytest.mark.parametrize("d,ff", sorted(SWIGLU_WIDTHS))
def test_tc_plans_every_swiglu_width(d, ff, M):
    """bf16 at every registered width plans the tensor-core kernel (its
    swap body at 8 rows, its prefill body at 256 and 4352), on a cluster
    size of ``swap_clusters(M, d)`` (one cluster over d) or of
    ``tc_clusters(d, TP_DS)`` (the decode body's sizes: one,
    ceil(d / 256), up to d 2048), S within the ff blocks and the
    workspace only where S > 1; the same plan with and without
    ``path="tc"``."""
    plan = lm.mlp_plan(M, d, ff, torch.bfloat16, True, 132, slots=_slots)
    if M >= lm.PREFILL_ROWS:
        assert (plan.path, plan.body, plan.bm) == ("tc", "prefill",
                                                   lm.TP_BM)
        assert plan.cl in lm.tc_clusters(d, lm.TP_DS)
    else:
        assert (plan.path, plan.body, plan.bm) == ("tc", "swap", 8)
        assert plan.cl in lm.swap_clusters(M, d)
    assert plan.cl <= lm.TC_MAX_CLUSTER
    if d <= 2048:
        assert lm.tc_clusters(d) == [-(-d // lm.TC_DS)]
    assert 1 <= plan.S <= -(-ff // lm.TC_BF)
    assert plan.workspace == (plan.S * M * d if plan.S > 1 else 0)
    assert plan == lm.mlp_plan(M, d, ff, torch.bfloat16, True, 132,
                               path="tc", slots=_slots)


@pytest.mark.parametrize("d", sorted({d for d, _ in SWIGLU_WIDTHS}
                                     | set(RAGGED_D)))
def test_tc_columns_cover_d_once(d):
    """At every cluster size the planner weighs, the CTAs' columns cover
    ``[0, d)`` exactly once, in whole clusters of cl; only the last
    cluster's last CTAs own nothing, and no cluster owns nothing."""
    for cl in lm.tc_clusters(d):
        assert 1 <= cl <= lm.TC_MAX_CLUSTER
        owners = lm.tc_columns(d, cl)
        assert len(owners) % cl == 0
        cols = np.zeros(d, np.int32)
        for q, c, c0, c1 in owners:
            assert 0 <= c < cl and c0 <= c1
            cols[c0:c1] += 1
        assert (cols == 1).all()
        n = len(owners) // cl
        assert n == -(-d // (lm.TC_DS * cl))
        for q in range(n):
            assert any(c1 > c0 for qq, _, c0, c1 in owners if qq == q)
        assert all(c1 > c0 for q, _, c0, c1 in owners if q < n - 1)


def test_tc_cluster_sizes_past_2048():
    """Past d 2048 the planner weighs the fewest clusters of at most 16
    (non-portable) up to those of at most 8 (portable)."""
    assert lm.tc_clusters(2048) == [8]
    assert lm.tc_clusters(2056) == [9, 5]
    assert lm.tc_clusters(4096) == [16, 8]
    assert lm.tc_clusters(6144) == [12, 8]
    assert lm.tc_clusters(7168) == [14, 10, 7]
    assert lm.tc_clusters(8192) == [16, 11, 8]


def test_tc_plan_forces_one_of_its_cluster_sizes():
    """``cl=`` plans one of the decode body's ``tc_clusters(d)`` sizes
    (phase 2 times the ones the planner did not choose) and raises for
    any other."""
    for cl in lm.tc_clusters(6144):
        plan = lm.mlp_plan(8, 6144, 16384, torch.bfloat16, True, 132,
                           path="tc", slots=_slots, cl=cl, body="decode")
        assert plan.path == "tc" and plan.cl == cl
    with pytest.raises(ValueError, match="not 16"):
        lm.mlp_plan(8, 6144, 16384, torch.bfloat16, True, 132, path="tc",
                    cl=16, body="decode")


@pytest.mark.parametrize("M", [8, 4352])
def test_tc_plan_skips_sizes_the_device_does_not_run(M):
    """A cluster size the occupancy calculator gives no slot is not
    planned; with none left, ``mlp_plan`` raises."""
    plan = lm.mlp_plan(M, 4096, 13696, torch.bfloat16, True, 132,
                       slots=lambda cl: 0 if cl > 8 else 15)
    assert plan.path == "tc" and plan.cl == 8
    with pytest.raises(ValueError, match="runs no cluster"):
        lm.mlp_plan(M, 4096, 13696, torch.bfloat16, True, 132,
                    slots=lambda cl: 0)


@pytest.mark.parametrize("d,ff", [(4096, 13696), (6144, 16384),
                                  (8192, 22016)])
def test_large_widths_fp32_and_refused_shapes_take_ffma(d, ff):
    """fp32 stays on the FFMA kernel; unaligned tensors and a d or ff off
    16-byte rows are refused by ``path="tc"`` and planned on FFMA."""
    for M in (8, 256):
        assert lm.mlp_plan(M, d, ff, torch.float32, True, 132).path == "ffma"
    for shape, aligned in (((d + 4, ff), True), ((d, ff + 4), True),
                           ((d, ff), False)):
        plan = lm.mlp_plan(8, *shape, torch.bfloat16, aligned, 132)
        assert plan.path == "ffma"
        with pytest.raises(ValueError, match="does not take"):
            lm.mlp_plan(8, *shape, torch.bfloat16, aligned, 132, path="tc")


def _mlp_inputs(M, d, ff, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, d)).astype(np.float32),
            (rng.normal(size=(d, ff)) / d ** 0.5).astype(np.float32),
            (rng.normal(size=(d, ff)) / d ** 0.5).astype(np.float32),
            (rng.normal(size=(ff, d)) / ff ** 0.5).astype(np.float32))


#: tests/test_kernels.py's kernel tolerances
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [4096, 6144, 8192])
def test_linked_mlp_plain_matches_pallas_at_large_widths(d, dtype):
    """The plain version against the reference's Pallas kernel in
    interpret mode (as ``tests/test_torch_linked_split.py`` runs it) at
    the large decoders' widths, M 8 and ff 512; the wrapper on CPU
    tensors launches nothing."""
    arrays = _mlp_inputs(8, d, 512, seed=d)
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    want = ref_lm.linked_mlp(*j, block_m=8, block_ff=128, interpret=True)
    kernels.reset_launches()
    got = lm.linked_mlp(*t)
    assert kernels.LAUNCHES["linked_mlp"] == 0
    assert torch.equal(got, lm.linked_mlp_plain(*t))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **TOL[dtype])


def _narrow(jcfg):
    """2 layers that keep the arch's head structure (q / kv heads,
    ``rope_fraction``, ``qk_norm``) at head_dim 16, ff 256, vocab 512, in
    fp32: ``reduced()`` would cut chatglm3-6b's 32 / 2 heads to G 2."""
    red = jcfg.reduced()
    return dataclasses.replace(
        red, n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads, head_dim=16,
        d_model=16 * jcfg.n_heads, d_ff=256, vocab=512)


_PAIRS: dict = {}


def _pair(arch):
    """(reference model, reference params, port model, port params) of
    :func:`_narrow`'s config.  An arch without qk-norm attends at its
    per-layer fan-in: the reference's init takes a stacked 4-D leaf's
    fan-in from its layer axis (2 here), so its raw scores make a one-hot
    softmax under which fp32 summation orders part past the tolerance
    (chatglm3 measured 1.3e-2), as ``tests/test_torch_recurrent.py``
    shows for hymba."""
    if arch not in _PAIRS:
        jcfg = _narrow(jax_get_config(arch))
        jm = JaxModel(jcfg)
        jp = jm.init(jax.random.key(0))
        if not jcfg.qk_norm:
            jp = _per_layer_fan_in(jp, jcfg)
        tm = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _PAIRS[arch] = (jm, jp, tm, tp)
    return _PAIRS[arch]


@pytest.mark.parametrize("arch", LARGE)
def test_narrow_configs_keep_head_structure(arch):
    ref = get_config(arch)
    cfg = _pair(arch)[2].cfg
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.rope_fraction, cfg.qk_norm,
            cfg.family) == (ref.n_heads, ref.n_kv_heads, ref.rope_fraction,
                            ref.qk_norm, ref.family)
    assert cfg.n_layers == 2 and cfg.resolved_head_dim == 16


@pytest.mark.parametrize("arch", LARGE)
def test_prefill_and_decode_logits_match_reference(arch):
    """One-shot prefill, then three decode steps under teacher forcing,
    through the ``linked_matmul`` site's ``cuda`` route (its plain
    version on CPU tensors), against the reference at rtol 3e-4."""
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(5)
    B, S, max_len = 3, 12, 32
    toks = rng.integers(0, jm.cfg.vocab, (B, S)).astype(np.int32)
    lens = np.asarray([12, 7, 5], np.int32)
    plan = KernelPlan(linked_matmul="cuda")
    lj, cj = jm.prefill_step(jp, {"tokens": jnp.asarray(toks),
                                  "lengths": jnp.asarray(lens)},
                             max_len=max_len)
    lt, ct = tm.prefill_step(tp, {"tokens": torch.from_numpy(toks),
                                  "lengths": torch.from_numpy(lens)},
                             max_len=max_len, plan=plan)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)
    for _ in range(3):
        nt = rng.integers(0, jm.cfg.vocab, (B, 1)).astype(np.int32)
        lj, cj = jm.serve_step(jp, cj, jnp.asarray(nt))
        lt, ct = tm.serve_step(tp, ct, torch.from_numpy(nt), plan=plan)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("arch", ["chatglm3-6b", "chameleon-34b"])
def test_chunk_and_decode_logits_match_reference(arch, kv):
    """The serving script of ``tests/test_torch_model.py`` (chunks of 4,
    then decode ticks with a bystander row), dense and paged: chatglm3's
    partial RoPE at G 16, chameleon's qk-norm at G 8."""
    jm, jp, tm, tp = _pair(arch)
    ref = _run_ref(jm, jp, kv)
    got = _run_port(tm, tp, kv)
    for i, (step, r, g) in enumerate(zip(_script(jm.cfg.vocab), ref, got)):
        rows = step[4]
        np.testing.assert_allclose(g[rows], r[rows], **RTOL,
                                   err_msg=f"{arch} {kv} step {i} {step[0]}")


@pytest.mark.parametrize("arch", LARGE)
def test_serving_init_is_bit_equal_to_cast_params(arch):
    """``Model.init(gen, dtype=bf16)`` draws each leaf as ``init`` does and
    casts it before the next: bit-equal to ``cast_params(init(gen))``,
    leaving the generator where ``init`` leaves it; serve.py's
    ``init_params`` is that init."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    model = Model(cfg, device="cpu")
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    want = model.cast_params(model.init(g1))
    got = model.init(g2, dtype=torch.bfloat16)
    a, b = tree_leaves(want), tree_leaves(got)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == torch.bfloat16 and torch.equal(x, y)
    assert torch.equal(torch.randn(4, generator=g1),
                       torch.randn(4, generator=g2))
    via = serve.init_params(model, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, tree_leaves(via)))


def test_serve_command_runs_a_large_decoder_reduced():
    """``launch.serve`` end to end on the host at granite-8b's reduced
    config: every request completes."""
    assert serve.main(["--arch", "granite-8b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--max-new", "3"]) == 0
