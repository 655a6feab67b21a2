"""Checkpoint and resume on the stacked transport, port against port.

A job killed after 3 of 5 rounds (``run(rounds=3)``; ``ckpt_every=2``
writes the engine's carry at rounds 0 and 2) and resumed
(``run(resume=True)``) re-enters at round 3 and ends where the
uninterrupted run ends: the resumed rounds' losses and the final global
bit for bit on the CPU (the reference's ``tests/test_resume.py`` holds
its own at rtol 1e-5), on every engine that checkpoints: the sync rounds
under ``"auto"`` and ``"loop"``, the compressed twins (int8 up, fp8 both
ways, ``topk-fixed``), the compressed host loop (int8 up, int8 both ways),
the buffered scan and GCML (its pairing draws replayed).  Each writes the
reference's engine tag, and a resumed run's ``comm`` counts the rounds it
ran.  DP resumes replay the noise stream.  The refusals are the
reference's ``ValueError``s: no ``checkpoint_dir``, another engine,
another DP mechanism, the buffered host loop; an empty store is a fresh
start and a resume after the last round runs none.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.core.session import BufferedScheduler  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TINY = dict(kind="dose", sites=3, batch=1, volume=(8, 8, 8), base_filters=4)
PAN = dict(kind="seg", sites=4, batch=1, in_channels=1, num_classes=2, volume=(8, 8, 8),
           base_filters=4)
DP = dict(dp_clip=0.5, dp_noise_multiplier=0.8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _job(**kw):
    base = dict(task=TaskConfig(**TINY), rounds=5, ckpt_every=2, max_dropout=1, device="cpu")
    base.update(kw)
    return FederatedJob(**base)


def _flat(tree):
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


def _resume_parity(tmp_path, **kw):
    """(uninterrupted result, resumed result, the job)."""
    ref = _job(**kw).run()
    job = _job(checkpoint_dir=str(tmp_path), **kw)
    job.run(rounds=3)
    res = job.run(resume=True)
    assert res.resumed_from == 2
    assert [h["round"] for h in res.history] == [3, 4]
    assert res.losses == ref.losses[3:]
    assert torch.equal(_flat(res.global_params), _flat(ref.global_params))
    return ref, res, job


ENGINES = [
    ("scan", dict(), "sync-scan"),
    ("loop", dict(round_engine="loop"), "sync-loop"),
    ("int8-scan", dict(compression="int8"), "compressed-scan"),
    ("int8-loop", dict(compression="int8", round_engine="loop"), "compressed-loop"),
    ("int8-both-loop", dict(compression="int8", down_compression="int8", round_engine="loop"),
     "compressed-loop-bidir"),
    ("fp8-both", dict(compression="fp8", down_compression="fp8"), "compressed-scan-bidir"),
    ("topk-fixed", dict(compression="topk-fixed"), "compressed-scan"),
    ("buffered-scan", dict(scheduler=BufferedScheduler(buffer_k=2)), "buffered-scan"),
    ("gcml", dict(strategy="gcml", task=TaskConfig(**PAN)), "sync-scan"),
]


@pytest.mark.parametrize("kw,tag", [e[1:] for e in ENGINES], ids=[e[0] for e in ENGINES])
def test_stacked_resume_equals_the_uninterrupted_run(kw, tag, tmp_path):
    ref, res, job = _resume_parity(tmp_path, **kw)
    store = CheckpointStore(tmp_path)
    assert store.saved_rounds("driver_state") == [0, 2, 4]
    assert store.saved_rounds("global") == [0, 2, 4]
    for r in (0, 2, 4):
        assert store.meta("driver_state", r)["engine"] == tag
        assert store.meta("driver_state", r)["dp"] is None
    if "partner" in ref.history[0]:
        assert [h["partner"] for h in res.history] == [h["partner"] for h in ref.history[3:]]
    if ref.comm is not None:
        masks = job.masks(5)
        assert res.comm["upload_count"] == int(masks[3:].sum())
        if job.compression == "none":
            assert res.comm["upload_bytes"] * int(masks.sum()) == \
                ref.comm["upload_bytes"] * int(masks[3:].sum())
        else:
            assert res.comm["upload_bytes"] == sum(h["upload_bytes"] for h in ref.history[3:])


@pytest.mark.parametrize("engine", ["scan", "loop"])
def test_dp_resume_replays_the_noise_stream(engine, tmp_path):
    ref, res, job = _resume_parity(tmp_path, round_engine=engine, **DP)
    assert CheckpointStore(tmp_path).meta("driver_state", 2)["dp"] == [0.5, 0.8, "per-site", 0]
    assert res.privacy == ref.privacy                 # epsilon of the full 5 rounds
    assert res.privacy["steps"] == 5


def test_resume_without_checkpoint_dir_raises():
    with pytest.raises(ValueError, match="run\\(resume=True\\) needs checkpoint_dir set"):
        _job().run(resume=True)


def test_resume_empty_store_is_fresh_start(tmp_path):
    res = _job(checkpoint_dir=str(tmp_path), rounds=2).run(resume=True)
    assert res.resumed_from is None and len(res.history) == 2


def test_resume_after_completion_is_a_noop_run(tmp_path):
    job = _job(checkpoint_dir=str(tmp_path), ckpt_every=1, rounds=3)
    done = job.run()
    res = job.run(resume=True)
    assert res.resumed_from == 2 and res.history == []
    assert math.isnan(res.final_loss) and math.isnan(res.to_dict()["final_loss"])
    assert torch.equal(_flat(res.global_params), _flat(done.global_params))


def test_resume_engine_mismatch_raises(tmp_path):
    _job(checkpoint_dir=str(tmp_path), round_engine="loop").run(rounds=3)
    with pytest.raises(ValueError) as err:
        _job(checkpoint_dir=str(tmp_path), round_engine="scan").run(resume=True)
    assert str(err.value) == (
        "driver_state checkpoint was written by engine 'sync-loop' but this run "
        "resolves to 'sync-scan'; resume with the same round_engine / compression / "
        "scheduler settings")


def test_buffered_loop_resume_rejected(tmp_path):
    sched = BufferedScheduler(buffer_k=2)
    _job(checkpoint_dir=str(tmp_path), scheduler=sched).run(rounds=3)
    with pytest.raises(ValueError, match="not checkpointable"):
        _job(checkpoint_dir=str(tmp_path), scheduler=sched, round_engine="loop").run(resume=True)


def test_dp_resume_refuses_mechanism_change(tmp_path):
    job = _job(checkpoint_dir=str(tmp_path), rounds=4, **DP)
    job.run(rounds=3)
    with pytest.raises(ValueError, match="DP settings") as err:
        job.replace(dp_noise_multiplier=0.3).run(resume=True)
    assert str(err.value) == (
        "driver_state checkpoint was written with DP settings [0.5, 0.8, 'per-site', 0] but "
        "this run resolves to [0.5, 0.3, 'per-site', 0]; resume with the same dp_clip / "
        "dp_noise_multiplier / dp_mode / seed")
    with pytest.raises(ValueError, match="DP settings"):
        job.replace(dp_clip=0.0, dp_noise_multiplier=0.0).run(resume=True)


def test_checkpoints_land_on_the_grid_and_hold_the_carry(tmp_path):
    """``ckpt_every=3`` over 7 rounds: rounds 0, 3 and 6, each a global in
    the reference's layout and the int8 twin's carry (the FL state with its
    round counter, the reference, the residuals)."""
    job = _job(checkpoint_dir=str(tmp_path), ckpt_every=3, rounds=7, compression="int8")
    res = job.run()
    store = CheckpointStore(tmp_path)
    assert store.saved_rounds("driver_state") == store.saved_rounds("global") == [0, 3, 6]
    zeros = {k: np.zeros(1) for k in ("params", "round")}
    like = {"fl_state": {**zeros, "opt": {"mu": 0, "nu": 0, "step": 0}, "strategy": {}},
            "reference": 0, "residual": 0}
    saved, meta = store.load("driver_state", 6, like)
    assert int(saved["fl_state"]["round"]) == 7
    np.testing.assert_array_equal(saved["fl_state"]["params"], res.state["params"].numpy())
    np.testing.assert_array_equal(saved["reference"], _flat(res.global_params).numpy())
    assert meta == {"engine": "compressed-scan", "dp": None}
