"""The port's multi-process mesh on the CPU: the cases of
tests/test_multihost.py, plus a differential against the JAX package.

Spawns a leader and followers (tests/_torch_multihost_runner.py), each
process holding 1-4 CPU shards, joined in one torch.distributed group over
gloo (the CPU stand-in for DCN), with the lockstep step pipe keeping every
process running the same steps. The leader's legs (decides, sync, upsert,
two submits in flight, GLOBAL hits, promotes, the window ring) assert
inside it. Then the runner's seeded traffic script runs on the JAX
package's MeshEngine of the same ("host", "chip") shape over conftest's 8
simulated devices in this process: the JAX multi-process engine is that
engine plus the step choreography, so its responses and its [n_shards,
...] store and sketch must equal the port's byte for byte, the processes'
shards stacked process-major.
"""

import re

import jax
import numpy as np
import pytest

import _torch_multihost_runner as runner


def _work(l_out: str) -> int:
    m = re.search(r"TOPO shards=(\d+) b_sub=(\d+)", l_out)
    assert m, l_out
    return int(m.group(1)) * int(m.group(2))


TOPOLOGIES = {(2, 1): 60, (2, 4): 120, (4, 2): 120}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Each topology's processes run ONCE; its test, the differential and
    the flatness check share the outputs (and the runner's files)."""
    results = {}

    def get(nprocs, per):
        if (nprocs, per) not in results:
            outdir = tmp_path_factory.mktemp(f"mh{nprocs}x{per}")
            results[(nprocs, per)] = (
                runner.run_group(nprocs, per, "cpu", outdir, TOPOLOGIES[(nprocs, per)]),
                outdir,
            )
        return results[(nprocs, per)]

    return get


def test_two_process_mesh(group):
    runner.assert_ok(*group(2, 1)[0])


def test_two_procs_four_shards_each(group):
    """2 hosts x 4 chips: 8 global shards, each process holding its
    contiguous four (asserted in every process), batch rows spread over
    all 8."""
    runner.assert_ok(*group(2, 4)[0])


def test_four_procs_two_shards_each(group):
    """4 hosts x 2 chips: three followers acking every step, 8 global
    shards."""
    runner.assert_ok(*group(4, 2)[0])


def test_cross_topology_work_flatness(group):
    """Padded work per real row (n_shards * B_sub over the rows) for the
    same rows-per-shard load stays within 2x across 2x1, 2x4 and 4x2."""
    results = {}
    for nprocs, per in TOPOLOGIES:
        out = group(nprocs, per)[0]
        runner.assert_ok(*out)
        results[(nprocs, per)] = _work(out[1]) / (16 * nprocs * per)
    worst = max(results.values()) / min(results.values())
    assert worst <= 2.0, results


@pytest.mark.parametrize("nprocs, per", list(TOPOLOGIES), ids=["2x1", "2x4", "4x2"])
def test_multiprocess_mesh_matches_the_jax_mesh(group, nprocs, per):
    """The runner's seeded traffic script on the JAX MeshEngine of the
    same (nprocs, per) shape, its epoch pinned where the leader's legs
    pinned the port's: every response, and the store and sketch with the
    processes' shards stacked process-major, byte for byte."""
    from gubernator_tpu.core.sketches import SketchConfig as JSketchConfig
    from gubernator_tpu.core.store import StoreConfig as JStoreConfig
    from gubernator_tpu.parallel.sharded import MeshEngine as JMeshEngine

    (l_rc, l_out, f_rcs, f_outs), outdir = group(nprocs, per)
    runner.assert_ok(l_rc, l_out, f_rcs, f_outs)
    n = nprocs * per
    j = JMeshEngine(JStoreConfig(**runner.STORE), devices=jax.devices()[:n],
                    buckets=runner.BUCKETS, mesh_shape=(nprocs, per),
                    sketch=JSketchConfig(**runner.SKETCH))
    j._engine_now(runner.T0)
    want = runner.traffic_script(j, n)
    got, store, sketch = runner.load_outputs(outdir, nprocs)
    runner.assert_same_outputs(got, want)
    np.testing.assert_array_equal(store, np.asarray(j.store.data))
    np.testing.assert_array_equal(sketch, np.asarray(j.sketch.data))
    assert store.any() and sketch.any(), "the script left no state to compare"


def test_config_mismatch_fails_loudly_at_connect(tmp_path):
    """A follower built with another bucket ladder is rejected by the
    connect-time handshake on BOTH sides with the mismatch diagnostic,
    neither hanging nor diverging later in lockstep."""
    runner.assert_mismatch_ok(*runner.run_group(
        2, 1, "cpu", tmp_path, 60, leader_role="leader-mismatch",
        follower_role="follower-mismatch",
    ))
