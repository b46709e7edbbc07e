"""Multi-host glue tests (single-process degenerate forms on the virtual
8-device CPU mesh) and plan config round-trips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import non_decimated_wavelets as nw
from non_decimated_wavelets.parallel import make_mesh, multihost


def test_global_mesh_and_sync():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = multihost.global_mesh({"x": 8})
    multihost.assert_mesh_synchronized(mesh)


def test_global_mesh_wrong_count():
    with pytest.raises(ValueError):
        multihost.global_mesh({"x": 3})


def test_host_local_array():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = multihost.global_mesh({"x": 8})
    base = np.arange(64, dtype=np.float32).reshape(64, 1) * np.ones((64, 16), np.float32)

    def fill(idx):
        return base[idx]

    arr = multihost.host_local_array((64, 16), mesh, P("x", None), fill)
    np.testing.assert_allclose(np.asarray(arr), base, atol=0)


def test_initialize_single_process_noop():
    multihost.initialize(num_processes=1)  # must not raise


@pytest.mark.parametrize(
    "visible, process_id, expected",
    [("3", 2, 0), ("0,1,2,3", 2, 2), ("0,1,2,3", 6, 2), ("4,5", 3, 1)],
)
def test_host_gpu_id(monkeypatch, visible, process_id, expected):
    """A launcher that leaves one GPU visible gets that card; otherwise
    the process id wraps over the host's visible GPUs."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert multihost.host_gpu_id(process_id) == expected


def test_plan_config_roundtrip():
    plan = nw.NDDWT(
        wavelet=("db2", "db4"), shape=(32, 64), preserve_l2=True, dtype="double"
    )
    cfg = plan.to_config()
    plan2 = nw.NDDWT.from_config(cfg)
    assert plan2.wavelets == plan.wavelets
    assert plan2.shape == plan.shape
    assert plan2.preserve_l2 == plan.preserve_l2
    assert plan2.real_dtype == plan.real_dtype
    for a, b in zip(plan.resp, plan2.resp):
        np.testing.assert_allclose(a, b, atol=0)


def test_two_process_distributed_roundtrip(tmp_path):
    """TRUE multi-process ``jax.distributed`` exercise:
    two OS processes, a coordinator on localhost, 4 virtual CPU devices
    each, one global {x:4, y:2} mesh — initialize / global_mesh /
    assert_mesh_synchronized / host_local_array / sharded dec+rec all
    cross the process boundary (Gloo collectives over DCN-analogue
    loopback). The reference has no multi-process anything (SURVEY §5)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    # Pick a free port for the coordinator.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts",
        "multihost_bench.py",
    )
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = []
    for pid in range(2):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, script, "--cpu",
                    "--shape", "32,16,8", "--wavelet", "db2", "--level", "2",
                    "--mesh", "x=4,y=2", "--iters", "2",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(pid),
                ],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"process failed (rc={rc}):\n{err[-2000:]}"
    # Process 0 prints the result JSON (amid Gloo chatter): last JSON line.
    result = None
    for line in outs[0][1].splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                result = json.loads(line)
            except json.JSONDecodeError:
                pass
    assert result is not None, f"no JSON from process 0:\n{outs[0][1][-2000:]}"
    assert result["processes"] == 2
    assert result["devices"] == 8
    assert result["max_abs_roundtrip_err_1pair"] < 1e-5


def test_initialize_propagates_bootstrap_failure():
    """A genuine bootstrap failure must raise, not be swallowed (a blanket
    except would mask real cluster failures). Run in a
    subprocess: a failed in-process distributed init is sticky."""
    import subprocess
    import sys

    code = (
        "import jax; jax.config.update('jax_platforms','cpu')\n"
        "from non_decimated_wavelets.parallel import multihost\n"
        "try:\n"
        "    multihost.initialize('127.0.0.1:1', num_processes=2,\n"
        "                         process_id=1, initialization_timeout=3)\n"
        "except Exception as e:\n"
        "    print('RAISED', type(e).__name__)\n"
        "else:\n"
        "    print('SWALLOWED')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120,
    )
    # jax surfaces the failure either as a Python exception (coordinator
    # side) or as a fatal-log process abort (worker side, jax 0.9) — both
    # are loud. The failure mode this guards against is initialize()
    # RETURNING as if the cluster were up.
    assert "SWALLOWED" not in r.stdout, r.stdout + r.stderr
    assert "RAISED" in r.stdout or r.returncode != 0, r.stdout + r.stderr


def test_desync_check_multi_axis():
    """The desync psum must cover every mesh axis and use
    placement-dependent contributions (a 2-axis mesh regression)."""
    import jax
    from non_decimated_wavelets.parallel import multihost

    mesh = multihost.global_mesh({"x": 4, "y": 2})
    multihost.assert_mesh_synchronized(mesh)
    mesh1 = multihost.global_mesh({"x": 8})
    multihost.assert_mesh_synchronized(mesh1)
