"""The port's training data, checkpoints and driver against the JAX
reference, on the CPU.

``SyntheticLM`` and ``make_train_iterator`` yield the reference's arrays
bit for bit (three seeds, two shard layouts), ``TokenFileDataset`` reads
uint16 and uint32 files as the reference does, checkpoints load across
the two packages both ways (params, and a full ``TrainState`` with int8
moments, under the same manifest keys), and ``python -m
repro_torch.launch.train`` runs the reference's CLI case on the CPU,
refuses ``--mesh`` and writes checkpoints the reference loads.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as jax_latest_step
from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.checkpoint.store import _path_str
from repro.configs.base import get_config as jax_get_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.data import TokenFileDataset as JaxTokenFile
from repro.data import make_train_iterator as jax_iterator
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.checkpoint.store import _map_keyed, to_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.data import SyntheticLM, TokenFileDataset, make_train_iterator
from repro_torch.launch import train as train_cli
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig

ARCH = "qwen3-1.7b"



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs: its steps are many
    small ops, and beside other test workers a full pool of spinning
    threads a process slowed one convergence test from ~4 s to ~390 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("shards,index", [(1, 0), (4, 2)])
@pytest.mark.parametrize("seed", [0, 1, 17])
def test_synthetic_stream_matches_reference(seed, shards, index):
    """``SyntheticLM.sample`` and three batches of ``make_train_iterator``
    (this shard's rows of each global batch of 8) are the reference's."""
    kw = dict(vocab=300, seq_len=24, seed=seed)
    np.testing.assert_array_equal(SyntheticLM(**kw).sample(5),
                                  JaxSyntheticLM(**kw).sample(5))
    port = make_train_iterator(SyntheticLM(**kw), 8, shard_index=index,
                               num_shards=shards)
    ref = jax_iterator(JaxSyntheticLM(**kw), 8, shard_index=index,
                       num_shards=shards)
    for _ in range(3):
        got, want = next(port), next(ref)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].shape == (8 // shards, 24)
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])
    with pytest.raises(ValueError, match="shards"):
        next(make_train_iterator(SyntheticLM(**kw), 6, num_shards=4))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_token_file_dataset_matches_reference(tmp_path, dtype):
    """A flat token file memory-mapped: windows of seq_len + 1, and the
    iterator's seeded draws over it, sharded, as the reference's."""
    rng = np.random.default_rng(8)
    hi = 60_000 if dtype == np.uint16 else 3_000_000_000
    path = tmp_path / "tokens.bin"
    rng.integers(0, hi, size=1001, dtype=np.int64).astype(dtype).tofile(path)
    port, ref = TokenFileDataset(path, 16, dtype), JaxTokenFile(path, 16, dtype)
    assert len(port) == len(ref) == 62
    idx = np.array([0, 61, 7, 7])
    np.testing.assert_array_equal(port.get(idx), ref.get(idx))
    assert port.get(idx).max() > 65_535 or dtype == np.uint16
    for index in (0, 1):
        got = make_train_iterator(port, 6, shard_index=index, num_shards=2,
                                  seed=3)
        want = jax_iterator(ref, 6, shard_index=index, num_shards=2, seed=3)
        for _ in range(2):
            a, b = next(got), next(want)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


# -- checkpoints -----------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_states():
    """The reference's reduced-qwen3 params and a TrainState with int8
    moments after one AdamW update (non-zero codes and scales)."""
    jcfg = jax_get_config(ARCH).reduced()
    opt = JaxAdamWConfig(moment_dtype="int8")
    jm = JaxModel(jcfg, opt_cfg=opt)
    state = jm.init_train_state(jax.random.key(0))
    rng = np.random.default_rng(9)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
        state.params)
    params, opt_state, _ = jax.jit(
        lambda p, g, s: jax_adamw_update(p, g, s, opt, 1e-3))(
            state.params, grads, state.opt)
    state = type(state)(params, opt_state, state.step + 1)
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu",
               opt_cfg=AdamWConfig(moment_dtype="int8"))
    return jm, tm, state


def _port_like(tm, kind):
    """Fresh port leaves of the checkpoint's structure (other values)."""
    state = tm.init_train_state(torch.Generator().manual_seed(1))
    return state.params if kind == "params" else state


def _ref_tree(state, kind):
    return state.params if kind == "params" else state


def _equal_leaves(port_tree, ref_tree):
    """Every leaf (a QuantMoment's q and scale apart) equal bit for bit;
    the two trees' structures match, key for key."""
    port_flat, ref_flat = {}, {}
    _map_keyed(lambda k, t: port_flat.__setitem__(k, to_numpy(t)),
               port_tree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        ref_flat["/".join(_path_str(p) for p in path)] = np.asarray(leaf)
    assert sorted(port_flat) == sorted(ref_flat)
    for k, v in ref_flat.items():
        assert port_flat[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port_flat[k], v, err_msg=k)


@pytest.mark.parametrize("kind", ["params", "train_state"])
def test_port_loads_reference_checkpoint(tmp_path, ref_states, kind):
    """The reference saves; the port restores onto its own structure:
    every leaf bit for bit, dtypes and ``requires_grad`` the template's."""
    jm, tm, state = ref_states
    tree = _ref_tree(state, kind)
    jax_save(tmp_path, 5, tree)
    got = load_checkpoint(tmp_path, 5, _port_like(tm, kind))
    _equal_leaves(got, tree)
    params = got if kind == "params" else got.params
    assert all(t.requires_grad for t in tree_leaves(params))
    if kind == "train_state":
        assert int(got.opt.step) == 1 and got.opt.m["embed"]["tokens"] \
            .q.dtype == torch.int8


@pytest.mark.parametrize("kind", ["params", "train_state"])
def test_reference_loads_port_checkpoint(tmp_path, ref_states, kind):
    """The port saves the reference's state carried across; the reference
    restores it bit for bit, and both wrote the same manifest keys."""
    jm, tm, state = ref_states
    tree = _ref_tree(state, kind)
    port = train_state_from_numpy(state, "cpu")
    save_checkpoint(tmp_path / "port", 3, port.params if kind == "params"
                    else port)
    jax_save(tmp_path / "ref", 3, tree)
    like = jax.tree.map(jnp.zeros_like, tree)
    back = jax_load(tmp_path / "port", 3, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    manifests = [json.loads((tmp_path / who / "step_00000003"
                             / "manifest.json").read_text())
                 for who in ("port", "ref")]
    assert manifests[0] == manifests[1]
    keys = manifests[0]["keys"]
    if kind == "train_state":
        assert ".step" in keys and ".opt/.step" in keys
        assert ".opt/.m/layers/attn/wq/0" in keys
        assert ".opt/.v/layers/attn/wq/1" in keys
        assert ".params/embed/tokens" in keys
    else:
        assert "embed/tokens" in keys and "layers/attn/wq" in keys


def test_bf16_moments_round_trip(tmp_path):
    """bfloat16 moments are stored as raw 2-byte records, as numpy writes
    the reference's; the port reads back its own and the reference's
    bit for bit."""
    jcfg = jax_get_config(ARCH).reduced()
    jm = JaxModel(jcfg, opt_cfg=JaxAdamWConfig(moment_dtype="bfloat16"))
    state = jm.init_train_state(jax.random.key(0))
    state = state._replace(opt=state.opt._replace(m=jax.tree.map(
        lambda p: (p * 3).astype(jnp.bfloat16), state.params)))
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu",
               opt_cfg=AdamWConfig(moment_dtype="bfloat16"))
    port = train_state_from_numpy(state, "cpu")
    assert port.opt.m["embed"]["tokens"].dtype == torch.bfloat16
    like = tm.init_train_state(torch.Generator().manual_seed(1))
    jax_save(tmp_path / "ref", 1, state)
    save_checkpoint(tmp_path / "port", 1, port)
    for who in ("ref", "port"):
        got = load_checkpoint(tmp_path / who, 1, like)
        for a, b in zip(tree_leaves(got.opt.m), tree_leaves(port.opt.m)):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_latest_step_and_shape_checks(tmp_path, ref_states):
    """``latest_step`` agrees with the reference's (None before any save);
    a stored shape other than the template's raises."""
    jm, tm, state = ref_states
    assert latest_step(tmp_path) is None is jax_latest_step(tmp_path)
    for step in (2, 11, 7):
        save_checkpoint(tmp_path, step, {"w": torch.ones(3)})
    (tmp_path / "other").mkdir()
    assert latest_step(tmp_path) == jax_latest_step(tmp_path) == 11
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path, 11, {"w": torch.ones(4)})
    with pytest.raises(KeyError, match="v"):
        load_checkpoint(tmp_path, 11, {"v": torch.ones(3)})


# -- the driver ------------------------------------------------------------------

def test_train_cli_runs(capsys):
    """The reference's ``test_train_cli_runs`` on the port's driver, on
    the CPU: eight finite losses and the reference's printed lines."""
    losses = train_cli.main(["--arch", "mamba2-370m", "--reduced",
                             "--steps", "8", "--batch", "4", "--seq", "32",
                             "--log-every", "4", "--device", "cpu"])
    assert len(losses) == 8 and all(np.isfinite(x) for x in losses)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=mamba2-370m-smoke params=")
    steps = [line for line in out if line.startswith("step ")]
    assert [int(line.split()[1]) for line in steps] == [0, 4, 7]
    assert all(" loss " in line and " gnorm " in line for line in steps)
    assert out[-1].startswith("loss ") and "improved" in out[-1]


@pytest.mark.parametrize("mesh", ["single", "auto"])
def test_train_cli_refuses_a_mesh(mesh, capsys):
    """``--mesh`` over more ranks than the visible cards (no device list,
    no ``--device cpu``) exits 2 with ``FAIL: ...``, as the reference's
    refuses a mesh it cannot build: never a silent one-device run."""
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", ARCH, "--reduced", "--mesh", mesh,
                        "--ranks", str(torch.cuda.device_count() + 2)])
    assert e.value.code == 2
    assert capsys.readouterr().err.startswith("FAIL: ")


def test_train_cli_checkpoints_load_in_the_reference(tmp_path):
    """``--ckpt-dir`` / ``--ckpt-every`` write the params every N steps;
    the reference restores the last onto its own params' structure, and
    the port onto its own, bit for bit alike."""
    train_cli.main(["--arch", ARCH, "--reduced", "--steps", "4", "--batch",
                    "2", "--seq", "8", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path), "--ckpt-every", "2"])
    assert latest_step(tmp_path) == jax_latest_step(tmp_path) == 4
    assert (tmp_path / "step_00000002" / "arrays.npz").exists()
    jcfg = jax_get_config(ARCH).reduced()
    ref = jax_load(tmp_path, 4, JaxModel(jcfg).init(jax.random.key(1)))
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    port = load_checkpoint(tmp_path, 4, tm.init(torch.Generator()))
    for a, b in zip(jax.tree.leaves(ref), tree_leaves(port)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(ref))
    fresh = params_from_numpy(jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.key(1))), "cpu")
    assert not torch.equal(fresh["embed"]["tokens"],
                           port["embed"]["tokens"])
