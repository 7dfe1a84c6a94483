"""TRUE 2-process distributed test (VERDICT r4 #3).

Every other distributed artifact in this repo (dryrun, unit tests, comm
analysis) is single-process over 8 virtual CPU devices, which exercises
the collectives but NOT process-boundary semantics: the jax.distributed
coordinator handshake (parallel/launch.py::initialize_distributed), the
global device view spanning processes, and per-process data feeding into a
multi-process mesh.  This test spawns 2 real processes x 4 virtual CPU
devices each over a local coordinator, runs the spatial distributed submap
adjustment (production configuration: use_split=True, non-trivial
normals), and asserts parity with the same optimization run
single-process in this test process.

Real multi-HOST runs differ only in the coordinator address and device
count; this is the closest CI-able approximation (SURVEY §5 distributed
backend row).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_spatial_parity(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "dist_worker.py")
    port = _free_port()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own 4-device count
    env["JAX_PLATFORMS"] = "cpu"  # workers run on virtual CPU devices

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), str(tmp_path)],
            env=env,
            cwd=repo,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=800)
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"

    params_2proc = np.load(tmp_path / "params.npy")
    n_cells, overflow = np.load(tmp_path / "meta.npy")
    assert overflow == 0
    assert n_cells > 20

    # single-process reference on the same problem (8 local devices via
    # conftest's xla_force_host_platform_device_count)
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dmsa_lidar_slam_tpu.parallel import keyframe_dist, spatial
    from tests.test_spatial_dist import _make_problem, _position_parity_m

    rng = np.random.default_rng(9)
    shapes, data, params0, _ = _make_problem(rng, with_normals=True)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    sopt = spatial.make_spatial_dist_optimize(
        mesh, shapes, num_iter=6, min_points=4, step_length=0.2, use_split=True
    )
    fp, fm, frs, aux = keyframe_dist.flatten_problem(data)
    grids = jnp.asarray([0.5, 1.25])
    params_1proc, _, _, ov1 = sopt(
        params0, fp, fm, frs, aux, grids,
        flat_normals=jnp.asarray(data.local_normals.reshape(-1, 3)),
    )
    assert int(ov1) == 0

    # 2-process and single-process runs shard the same 8-way mesh over the
    # same problem; only process boundaries (and f32 reduction order across
    # them) differ
    parity = _position_parity_m(shapes, data, jnp.asarray(params_2proc), params_1proc)
    assert parity < 0.01, f"2-process vs single-process parity {parity:.5f} m"
