"""The top-level entry points on the CPU: __graft_entry__ and bench.py.

Their measured runs need a GPU; here they are checked for what they compute
on virtual CPU devices, and for refusing to measure on the CPU.
"""

import jax
import numpy as np
import pytest

import __graft_entry__
import bench


def test_entry_forward_is_the_bp4_operator():
    from mf_data_locality.models import bp4

    fn, (op, b) = __graft_entry__.entry()
    out = jax.jit(fn)(op, b)
    problem = bp4.build(s=6, degree=3)
    expect = problem.a_apply_full(problem.b)
    assert out.shape == b.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(expect),
                               rtol=1e-5, atol=1e-5 * float(abs(expect).max()))


def test_dryrun_multichip_on_virtual_devices(capsys):
    __graft_entry__.dryrun_multichip(8)
    out = capsys.readouterr().out
    assert "dryrun_multichip(8)" in out and "3D mesh (2x2x2)" in out


def test_dryrun_multichip_refuses_missing_devices():
    with pytest.raises(RuntimeError, match="needs 16 devices"):
        __graft_entry__.dryrun_multichip(16)


def test_bench_refuses_cpu_device(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert '"metric"' not in capsys.readouterr().out
