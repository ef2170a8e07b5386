"""d-Xenos's parameter-synchronization schedules on the port
(``repro_torch.distributed.collectives``) against the reference's.

The reference's case (``tests/test_distributed.py``: 8 ranks, rows of 33,
so the ring pads) with random normal rows, and p = 3 (rows of 34: padded
again) and p = 1.  The reference runs once, in a subprocess with 8 host
devices (``conftest.run_multidevice``); the port runs once, 8 gloo ranks
on the host (``launch.mesh.spawn_ranks``), each rank in every group of
the first p ranks.  Both schedules fix the order of summation, so every
rank's fp32 result must equal the reference's rank bit for bit.
"""
import importlib.util

import numpy as np
import pytest

import test_torch_ranks as R
from conftest import REPO, run_multidevice
from repro_torch.launch.mesh import spawn_ranks

#: group size -> row width (33 % 8 and 34 % 3 leave a remainder: padding)
WIDTHS = {8: 33, 3: 34, 1: 5}

_REFERENCE = """
import numpy as np, jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed import ring_allreduce, ps_sync
from repro.distributed.compat import shard_map
cases = dict(np.load({inp!r}))
out = {{}}
for key, rows in cases.items():
    p = rows.shape[0]
    mesh = Mesh(np.array(jax.devices()[:p]), ("x",))
    for kind, fn in (("ring", ring_allreduce), ("ps", ps_sync)):
        f = jax.jit(shard_map(lambda xs, fn=fn: fn(xs[0], "x")[None],
                              mesh=mesh, in_specs=P("x", None),
                              out_specs=P("x", None), check_vma=False))
        out[f"{{kind}}/{{p}}"] = np.asarray(f(jax.numpy.asarray(rows)))
np.savez({outp!r}, **out)
print("REFERENCE_OK")
"""


def _cases() -> dict:
    rng = np.random.default_rng(0)
    return {p: rng.normal(size=(p, w)).astype(np.float32)
            for p, w in WIDTHS.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """kind/p -> (p, width) array: rank r's result in row r."""
    d = tmp_path_factory.mktemp("collectives")
    inp, outp = d / "in.npz", d / "out.npz"
    np.savez(inp, **{str(p): rows for p, rows in _cases().items()})
    out = run_multidevice(_REFERENCE.format(inp=str(inp), outp=str(outp)),
                          n_devices=8)
    assert "REFERENCE_OK" in out
    return dict(np.load(outp))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """One result dict a rank (``test_torch_ranks.collectives_rank``)."""
    return spawn_ranks(R.collectives_rank, 8, args=(_cases(),),
                       devices=["cpu"] * 8, timeout_s=240.0,
                       store_dir=tmp_path_factory.mktemp("store"))


@pytest.mark.parametrize("p", [8, 3])
@pytest.mark.parametrize("kind", ["ring", "ps"])
def test_schedule_equals_reference_bit_for_bit(reference, port, kind, p):
    want = reference[f"{kind}/{p}"]
    for rank in range(p):
        got = port[rank][p][kind]
        assert got.dtype == np.float32 and got.shape == (WIDTHS[p],)
        assert got.tobytes() == want[rank].tobytes(), (kind, p, rank)


@pytest.mark.parametrize("p", [8, 3])
@pytest.mark.parametrize("kind", ["ring", "ps"])
def test_schedule_equals_all_reduce(port, kind, p):
    """The reference's check (``rtol=1e-6`` against ``psum``), here
    against ``dist.all_reduce`` and the fp64 sum; the input is kept."""
    rows = _cases()[p]
    for rank in range(p):
        r = port[rank][p]
        np.testing.assert_allclose(r[kind], r["all_reduce"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r[kind], rows.astype(np.float64).sum(0),
                                   rtol=1e-6, atol=1e-6)
        assert r["input_kept"]


def test_one_rank_returns_its_input(port):
    assert port[0][1]["identity"]
    np.testing.assert_array_equal(port[0][1]["ring"], _cases()[1][0])
    assert all(1 not in r for r in port[1:])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("p", [8, 3])
@pytest.mark.parametrize("kind", ["ring", "ps"])
def test_chip_smoke_schedule_sums_equal_reference(reference, kind, p):
    """The card's oracle (``chip_smoke.schedule_sum``: numpy, each element
    summed in the schedule's order) gives the reference's bits."""
    got = _chip_smoke().schedule_sum(_cases()[p], kind)
    assert got.tobytes() == reference[f"{kind}/{p}"][0].tobytes()
