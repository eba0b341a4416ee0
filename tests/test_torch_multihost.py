"""The port's data parallelism (``parallel.multihost``, ``.distributed``)
against the JAX package's on the CPU.

One process: the no-ops against JAX's (``data_shard``, ``is_primary``,
``broadcast_scalar``, ``any_flag``, ``validate_global_batch``'s message);
``init_distributed`` / ``assert_pod_consistency`` under patched
environments; the device draws of a global batch taken in slices (each
process draws for the whole global batch and applies its rows, so the
draws do not depend on the process count).

A 2-rank gloo cluster (tests/torch_dp_worker.py, one torch thread each,
every wait bounded): ``barrier`` (and a mismatched tag raising on both),
``broadcast_scalar``, ``any_flag`` with one rank True, ``BatchLoader(
shard=)`` slices equal to JAX's, a metrics line written once; a WDSR step
(2 channels, so the label dice couples the batch) and a FLAVR step with
label channels against the 1-process step on the global batch (relative
norm per leaf, 1e-5: only the fp32 summation order differs), the WDSR one
also against JAX's (1e-4, tests/test_torch_sr_train's NORM_TOL); the
parameters equal bit for bit across ranks; a checkpoint written once and
restored by both; ``_train_sr_loop(dp_mesh=)`` over 3 steps against the
1-process loop on the same global stream."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from rehrseg_tpu_torch.data import device_aug, device_sr_sim
from rehrseg_tpu_torch.parallel import distributed, multihost as mh
from rehrseg_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
STEP_TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cluster(scenario, out_dir, world=2, timeout=240):
    """Spawn ``world`` worker ranks of ``scenario``; their results."""
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "REHRSEG_NUM_PROCESSES", "REHRSEG_COORDINATOR"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(r), str(world), port,
         str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, text=True) for r in range(world)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [torch.load(os.path.join(out_dir, f"{scenario}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ------------------------------------------------------------ one process

def test_single_process_noops_match_jax():
    from rehrseg_tpu.parallel import multihost as jmh

    assert mh.data_shard() is None and jmh.data_shard() is None
    assert mh.is_primary() and jmh.is_primary()
    assert not mh.is_multihost() and not jmh.is_multihost()
    assert mh.broadcast_scalar(0.25) == jmh.broadcast_scalar(0.25) == 0.25
    assert mh.any_flag(True) is jmh.any_flag(True) is True
    assert mh.any_flag(False) is jmh.any_flag(False) is False
    tree = {"a": torch.ones(2)}
    assert mh.replicate_global(tree) is tree
    mh.barrier("nothing")


def test_validate_global_batch_message_matches_jax():
    from rehrseg_tpu.parallel import make_mesh as jax_make_mesh
    from rehrseg_tpu.parallel.multihost import validate_global_batch

    mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    mh.validate_global_batch(16, mesh)
    with pytest.raises(ValueError) as want:
        validate_global_batch(2, jax_make_mesh(8), what="batch_size_segsr")
    with pytest.raises(ValueError) as got:
        mh.validate_global_batch(2, mesh, what="batch_size_segsr")
    assert str(got.value) == str(want.value)
    mh.validate_global_batch(3)          # one process: any batch


def test_init_distributed_and_pod_consistency(monkeypatch):
    """One process, or a group already formed: a no-op returning False;
    N processes without an address raise; NCCL without a card raises
    rather than falling back to gloo; an environment naming several
    processes with no group formed fails the consistency check unless
    REHRSEG_NUM_PROCESSES=1 opts out."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "REHRSEG_COORDINATOR",
                "REHRSEG_NUM_PROCESSES", "REHRSEG_PROCESS_ID",
                "REHRSEG_PLATFORM", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False
    distributed.assert_pod_consistency()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init_distributed()
    with pytest.raises(RuntimeError, match="not initialized"):
        distributed.assert_pod_consistency()
    monkeypatch.setenv("REHRSEG_NUM_PROCESSES", "1")
    assert distributed.init_distributed() is False
    distributed.assert_pod_consistency()
    monkeypatch.setenv("REHRSEG_NUM_PROCESSES", "2")
    monkeypatch.setenv("REHRSEG_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("REHRSEG_PROCESS_ID", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.init_distributed()
    assert not distributed.cpu_requested()
    monkeypatch.setenv("REHRSEG_PLATFORM", "cpu")
    assert distributed.cpu_requested()


def test_global_draws_in_slices():
    """Draws independent of the process count: two processes' slices of a
    global batch, each drawing for the whole global batch from a generator
    seeded alike, give the rows of the one-process draw: the LR
    simulation's slice dropout, the stage-1 HR augmentation and the stage-2
    augmentation."""
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.uniform(size=(4, 16, 4, 8, 2)).astype(
        np.float32))
    hr = torch.from_numpy(rng.uniform(size=(4, 4, 8, 8, 2)).astype(
        np.float32))
    seg = [torch.from_numpy(rng.uniform(size=(4, 2, 12, 12, 1)).astype(
        np.float32)) for _ in range(3)]
    lhr = torch.from_numpy((rng.uniform(size=(4, 8, 12, 12, 1)) > 0.5)
                           .astype(np.float32))

    def gen():
        return torch.Generator().manual_seed(7)

    fns = (
        lambda g, rows, shard: device_sr_sim.simulate_lr_batch(
            g, src[rows], 4.0, shard=shard),
        lambda g, rows, shard: device_aug.augment_sr_hr_batch(
            g, hr[rows], shard=shard),
        lambda g, rows, shard: device_aug.augment_seg_batch(
            g, seg[0][rows], seg[1][rows], lhr[rows], seg[2][rows],
            patch_hw=(8, 8), shard=shard))
    for fn in fns:
        whole = fn(gen(), slice(0, 4), None)
        whole = [whole] if isinstance(whole, torch.Tensor) else whole
        for r in range(2):
            part = fn(gen(), slice(2 * r, 2 * r + 2), (r, 2))
            part = [part] if isinstance(part, torch.Tensor) else part
            for p, w in zip(part, whole):
                torch.testing.assert_close(p, w[2 * r:2 * r + 2], rtol=0,
                                           atol=0)


# ------------------------------------------------------------ two processes

@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    return out, run_cluster("multihost", out)


def test_collectives(cluster):
    _, ranks = cluster
    for r, res in enumerate(ranks):
        assert res["multihost"] and res["primary"] == (r == 0)
        assert res["shard"] == (r, 2)
        assert res["rows"] == list(range(4 * r, 4 * r + 4))
        assert res["broadcast"] == 3.5
        assert res["any_one"] is True and res["any_none"] is False
        assert "different barriers" in res["mismatch"]


def test_sharded_loader_matches_jax(cluster):
    """Each rank's BatchLoader(shard=) batches equal JAX's for the same
    shard, and together the unsharded-by-seeds global batch."""
    from rehrseg_tpu.data.datasets import BatchLoader as JaxBatchLoader
    from tests.torch_dp_worker import Probe

    _, ranks = cluster
    for r, res in enumerate(ranks):
        jl = JaxBatchLoader(Probe(), 8, seed=3, shard=(r, 2))
        for got in res["loader"]:
            np.testing.assert_array_equal(got, jl.next()[0])
    whole = JaxBatchLoader(Probe(), 8, seed=3, shard=(0, 1)).next()[0]
    np.testing.assert_array_equal(
        np.concatenate([res["loader"][0] for res in ranks]), whole)


def test_metrics_and_checkpoint_written_once(cluster):
    out, ranks = cluster
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1 and lines[0]["rank"] == 0
    assert [res["saves"] for res in ranks] == [1, 0]
    assert all(res["restored_equal"] for res in ranks)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["1"]


@pytest.mark.parametrize("kind", ["wdsr", "flavr"])
def test_dp_sr_step_matches_one_process(cluster, kind):
    """The 2-rank step against the 1-process step on the global batch: the
    logged loss (the global batch's), every gradient and the parameters
    after the update; parameters bit-equal across ranks."""
    _, ranks = cluster
    a, b = (res[kind] for res in ranks)
    assert a["digest"] == b["digest"]
    for res in (a, b):
        assert res["loss"] == pytest.approx(res["ref_loss"], rel=STEP_TOL)
        assert res["grad_err"] < STEP_TOL, res["grad_err"]
        assert res["param_err"] < STEP_TOL, res["param_err"]


def test_dp_wdsr_step_matches_jax(cluster):
    """The 2-rank WDSR step's gradients and parameters against JAX's
    1-process step on the global batch (gradients from Adam's first
    moment, as tests/test_torch_sr_train.py reads them)."""
    import jax
    import jax.numpy as jnp

    from rehrseg_tpu.models import WDSR as JaxWDSR
    from rehrseg_tpu.train import optim as joptim
    from rehrseg_tpu.train import sr_trainer as jsr
    from rehrseg_tpu.train.state import TrainState as JaxTrainState
    from rehrseg_tpu_torch.models import convert
    from rehrseg_tpu_torch.models.wdsr import WDSR
    from tests.test_torch_train import NORM_TOL, _floor, _rel
    from tests.torch_dp_worker import WDSR_KW, wdsr_batch

    _, ranks = cluster
    lr, hr = wdsr_batch()
    p_np = convert.random_wdsr_params(0, **WDSR_KW)
    tx, _ = joptim.onecycle_adam(1e-3, 2)
    params = jax.tree.map(jnp.asarray, p_np)
    state = JaxTrainState(params=params, opt_state=jax.jit(tx.init)(params),
                          step=0)
    step = jsr.make_sr_train_step(JaxWDSR(**WDSR_KW), tx,
                                  enable_uncertainty=False,
                                  slice_separation=4.0, num_slices=1,
                                  precision="fp32")
    state, m = step(state, jnp.asarray(lr), jnp.asarray(hr))
    g = jax.tree.map(lambda a: np.asarray(a, np.float64) / 0.1,
                     state.opt_state[0].mu)

    def sd(tree):
        mod = WDSR(**WDSR_KW)
        convert.load_flax_wdsr_params(mod, tree)
        return {f"0.{k}": v for k, v in mod.state_dict().items()}

    jg = sd(g)
    jp = sd(jax.tree.map(np.asarray, state.params))
    for res in ranks:
        got = res["wdsr"]
        assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
        floor = _floor(jg)
        for k in jg:
            assert _rel(got["grads"][k].numpy(), jg[k].numpy(),
                        floor) < NORM_TOL, k
            assert _rel(got["weights"][k].numpy(), jp[k].numpy()) \
                < NORM_TOL, k


def test_dp_train_sr_loop_matches_one_process(cluster, tmp_path):
    """``_train_sr_loop(dp_mesh=)`` on 2 ranks (rank 1 started from other
    weights: the loop's broadcast replaces them) against the 1-process
    loop over the same global stream: weights within 1e-5, the
    checkpoint and one metrics line a step written once."""
    from rehrseg_tpu_torch import pipeline
    from rehrseg_tpu_torch.data.datasets import BatchLoader
    from rehrseg_tpu_torch.train.sr_trainer import make_sr_train_step
    from tests.torch_dp_worker import (SR_BATCH, rel_errors, sr_model,
                                       sr_state, wdsr_dataset, weights_of)

    out, ranks = cluster
    model = sr_model("wdsr")
    state = sr_state(model, 3)
    step = make_sr_train_step(model, enable_uncertainty=False,
                              slice_separation=4, num_slices=1)
    loader = BatchLoader(wdsr_dataset(), SR_BATCH, seed=4, shard=(0, 1))
    pipeline._train_sr_loop(state, loader, step, 3, 2,
                            str(tmp_path / "loop"),
                            device=torch.device("cpu"), log_every=1,
                            dp_mesh=make_mesh(devices=["cpu"]))
    want = weights_of(model)
    for res in ranks:
        assert max(rel_errors(res["loop"], want).values()) < STEP_TOL
    loop_dir = os.path.join(out, "loop")
    # a save at it = 2 (step 3) and the final one at step 3
    assert sorted(os.listdir(loop_dir)) == ["3", "metrics.jsonl"]
    with open(os.path.join(loop_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1, 2]
