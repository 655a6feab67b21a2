"""The port's FedAvg job against the JAX job, and the port's boundaries.

Trajectory parity: a 3-site SA-Net dose job (16^3, ``base_filters=8``,
2 levels) with Algorithm-2 churn runs in both packages from the same
initial parameters (the JAX init, converted) and the same host batches.
The gate is per-round, per-site loss parity, not loss descent (the
reference's dose loss does not fall monotonically).  Tolerances: losses
rtol 1e-4, atol 1e-5 (fp32 round-off through a few AdamW steps);
parameters |diff| <= lr per round, since AdamW's first step is about
``lr * sign(g)`` and flips where float noise flips the sign of a
near-zero gradient, while the median coordinate agrees to 1e-6 and
fewer than 1% differ by more than 1e-4.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro_torch import NotPorted, convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TASK = dict(kind="dose", sites=3, batch=2)


@pytest.mark.parametrize("scenario", ["disconnect", "shutdown"])
def test_fedavg_trajectory_matches_jax_job(scenario):
    job_kw = dict(strategy="fedavg", rounds=3, max_dropout=1, seed=0,
                  dropout_scenario=scenario)
    jjob = JJob(task=JTask(**TASK), **job_kw)
    jres = jjob.run()
    init = jjob.task.build().init_fn(jax.random.PRNGKey(jjob.seed))
    tres = FederatedJob(task=TaskConfig(**TASK), device="cpu", **job_kw).run(
        init_params=convert.from_reference(jax.tree.map(np.asarray, init)))
    assert [h["active"] for h in tres.history] == [h["active"] for h in jres.history]
    assert min(h["active"] for h in jres.history) < 3      # a masked round ran
    for th, jh in zip(tres.history, jres.history):
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
    want = convert.from_reference(jax.tree.map(np.asarray, jres.global_params))
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in
                      zip(tree_leaves(tres.global_params), tree_leaves(want))])
    assert float(diff.max()) <= jjob.lr * jjob.rounds
    assert float(diff.median()) <= 1e-6
    assert float((diff > 1e-4).float().mean()) < 0.01
    assert tres.comm == jres.comm
    assert tres.privacy is jres.privacy is None


def test_history_holds_each_rounds_times_and_on_round_sees_each_round():
    seen = []
    res = FederatedJob(task=TaskConfig(**TASK), rounds=2, device="cpu").run(
        on_round=seen.append)
    assert seen == [0, 1]
    for h in res.history:
        assert 0 < h["batch_s"] < h["wall_s"] and 0 < h["step_s"] < h["wall_s"]
        assert h["wall_s"] == pytest.approx(h["batch_s"] + h["step_s"], rel=1e-3)


def test_job_runs_on_cuda_by_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedJob()
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedJob(device="cuda:0")
    assert FederatedJob(device="cpu").torch_device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert FederatedJob().torch_device == torch.device("cuda")


# a case whose seam has since been ported names another seam still
# unported, under the id it always had (the device_data and shard_sites
# cases keep their field; since the token task was ported, they train an
# architecture the port has not got and name the arch seam: since every
# token architecture was ported, sanet-openkbp, the registry's one id
# outside the port's)
TOKENS = TaskConfig(**dict(TASK, kind="tokens", arch="sanet-openkbp"))


@pytest.mark.parametrize("seam,kw", [
    pytest.param("arch", dict(scheduler="buffered", dp_clip=1.0, device_data=True, task=TOKENS),
                 id="scheduler-kw0"),
    pytest.param("arch", dict(strategy="fedprox", transport="thread", topology="pods:2",
                              dp_clip=1.0, device_data=True, task=TOKENS), id="strategy-kw1"),
    pytest.param("arch", dict(compression="fp8", dp_clip=1.0, dp_noise_multiplier=1.0,
                              shard_sites=True, task=TOKENS), id="compression-kw2"),
    pytest.param("arch", dict(down_compression="topk-fixed", device_data=True, task=TOKENS),
                 id="down_compression-kw3"),
    pytest.param("arch", dict(dp_clip=1.0, device_data=True, task=TOKENS), id="dp-kw4"),
    pytest.param("arch", dict(device_data=True, task=TOKENS), id="device_data-kw5"),
    pytest.param("arch", dict(adversary="noise:1:1", device_data=True, task=TOKENS),
                 id="adversary-kw6"),
    pytest.param("arch", dict(strategy="fedprox", aggregator="median", transport="thread",
                              dp_clip=1.0, device_data=True, task=TOKENS), id="strategy-kw7"),
    pytest.param("arch", dict(topology="pods:2", dp_clip=1.0, shard_sites=True, task=TOKENS),
                 id="topology-kw8"),
    pytest.param("arch", dict(topology="pods:2", device_data=True, task=TOKENS),
                 id="topology-kw9"),
    pytest.param("arch", dict(shard_sites=True, task=TOKENS), id="shard_sites-kw10"),
    pytest.param("arch", dict(task=TaskConfig(kind="tokens", arch="sanet-openkbp")),
                 id="task-kw11"),
    pytest.param("arch", dict(compression="fp8", strategy="gcml", transport="tcp",
                              device_data=True, task=TOKENS), id="strategy-kw12"),
])
def test_unported_seams_raise_a_typed_error(seam, kw):
    job = FederatedJob(task=TaskConfig(**TASK), rounds=1, device="cpu").replace(**kw)
    with pytest.raises(NotPorted) as err:
        job.run()
    assert err.value.seam == seam
    assert isinstance(err.value, NotImplementedError)


# ROADMAP C1: compositions the reference refuses on the stacked transport
REFUSED = [
    (dict(secure_agg=True), "no wire to protect"),
    (dict(scheduler="buffered", adversary="sign_flip:1"), "no in-round fault seam"),
    (dict(scheduler="buffered", aggregator="normclip:1"), "plain running sum"),
    (dict(scheduler="buffered", down_compression="int8"), "needs scheduler='sync'"),
    (dict(strategy="individual", down_compression="int8"), "fedavg/fedprox"),
    (dict(shard_sites=True, down_compression="int8"), "shard_sites=False"),
    (dict(round_deadline_s=5.0), "wall-clock barrier"),
    (dict(max_upload_norm=10.0), "upload sanitation"),
]


@pytest.mark.parametrize("kw,frag", REFUSED)
def test_refused_compositions_raise_the_reference_value_error(kw, frag):
    with pytest.raises(ValueError, match=frag):
        JJob(task=JTask(**TASK), rounds=1, **kw).run()
    with pytest.raises(ValueError, match=frag):
        FederatedJob(task=TaskConfig(**TASK), rounds=1, device="cpu", **kw).run()


def _pods(mod, **kw):
    return dict(topology=mod.Topology.pods(2, **kw))


# the reference's refused compositions of the topology and buffered seams on
# the stacked transport, in its order of checks: (kw from the package's
# topology module, the message fragment)
REFUSED_TIERS = [
    (lambda m: dict(pod_dropout=1), "pod_dropout requires a pods topology"),
    (lambda m: dict(topology="pods:2", pod_dropout=2), "must be < num_pods"),
    (lambda m: dict(topology="pods:4"), "leaves empty pods"),
    (lambda m: dict(topology=m.Topology.pods(2, assignment=(0, 0, 0))), "pod 1 has no sites"),
    (lambda m: dict(topology="pods:2", scheduler="buffered"), "synchronously at both tiers"),
    (lambda m: _pods(m, inter_scheduler="buffered"), "synchronously at both tiers"),
    (lambda m: _pods(m, intra_scheduler="buffered"), "synchronously at both tiers"),
    (lambda m: dict(aggregator="median", **_pods(m, inter_scheduler="buffered")),
     "side by side"),
    (lambda m: dict(down_compression="int8", **_pods(m, intra_scheduler="buffered")),
     "needs scheduler='sync'"),
    (lambda m: dict(topology="pods:2", strategy="individual"), "centrally-aggregated"),
    (lambda m: dict(scheduler="buffered", round_deadline_s=1.0), "no barrier to bound"),
    (lambda m: dict(topology="pods", rounds=1), "needs a pod count"),
]


@pytest.mark.parametrize("make,frag", REFUSED_TIERS, ids=[f for _, f in REFUSED_TIERS])
def test_refused_tier_compositions_raise_the_reference_value_error(make, frag):
    from repro.core import topology as jtopo
    from repro_torch.core import topology as ttopo
    with pytest.raises(ValueError, match=frag):
        JJob(task=JTask(**TASK), rounds=1).replace(**make(jtopo)).run()
    with pytest.raises(ValueError, match=frag):
        FederatedJob(task=TaskConfig(**TASK), rounds=1, device="cpu").replace(
            **make(ttopo)).run()


# fields of the reference's job and task that name an unported seam:
# (field, a value other than the default, the seam NotPorted names; None:
# the seam has since been ported, and the value is the reference's
# ValueError on its own; "ported": the seam has since been ported and the
# value runs)
FIELDS = [
    pytest.param("dp_clip", 1.0, "ported", id="dp_clip-1.0-dp"),
    pytest.param("dp_noise_multiplier", 1.0, "ported", id="dp_noise_multiplier-1.0-dp"),
    pytest.param("pod_dropout", 1, None, id="pod_dropout-1-topology"),
    pytest.param("device_data", True, "ported", id="device_data-True-device_data"),
    pytest.param("dp_delta", 1e-6, "ported", id="dp_delta-1e-06-dp"),
    pytest.param("dp_mode", "per-example", "ported", id="dp_mode-per-example-dp"),
    pytest.param("round_engine", "loop", "ported", id="round_engine-loop-round_engine"),
    pytest.param("chunk_rounds", 2, "ported", id="chunk_rounds-2-round_engine"),
    pytest.param("ckpt_every", 5, "ported", id="ckpt_every-5-checkpoint"),
    pytest.param("task.arch", "gemma3-1b", "ported", id="task.arch-gemma3-1b-task"),
    pytest.param("task.reduced", False, "ported", id="task.reduced-False-task"),
    pytest.param("task.seq", 32, "ported", id="task.seq-32-task"),
    pytest.param("checkpoint_dir", "ckpt", "ported", id="checkpoint_dir-ckpt-checkpoint"),
    pytest.param("shard_sites", True, "ported", id="shard_sites-True-shard_sites"),
]


def _default(cls, name):
    f = {f.name: f for f in dataclasses.fields(cls)}[name]
    return f.default if f.default is not dataclasses.MISSING else f.default_factory()


@pytest.mark.parametrize("name,other,seam", FIELDS)
def test_reference_fields_take_their_defaults_and_refuse_other_values(name, other, seam):
    """A spec that names the field at the reference's default builds the
    port's job and passes its seam check; any other value raises
    ``NotPorted``."""
    if name.startswith("task."):
        field = name[len("task."):]
        job = FederatedJob(task=TaskConfig(**TASK, **{field: _default(JTask, field)}),
                           rounds=1, device="cpu")
        bad = job.replace(task=TaskConfig(**TASK, **{field: other}))
    else:
        job = FederatedJob(task=TaskConfig(**TASK), rounds=1, device="cpu",
                           **{name: _default(JJob, name)})
        bad = job.replace(**{name: other})
    job.check_ported()
    if seam == "ported":          # the seam's behaviour: test_torch_codec_engine.py,
        bad.check_ported()        # test_torch_dp.py, test_torch_resume.py,
        return                    # test_torch_device_data.py, test_torch_sharded.py,
                                  # test_torch_tokens.py
    if seam is None:
        with pytest.raises(ValueError, match="requires a pods topology"):
            bad.run()
        bad.replace(topology="pods:2").check_ported()
        return
    with pytest.raises(NotPorted) as err:
        bad.run()
    assert err.value.seam == seam


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{f}: imports {mod}"
        assert "import jax" not in f.read_text(), f
        assert "import ml_dtypes" not in f.read_text(), f


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; chip_smoke.py would run in full")
    import subprocess
    import sys
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# -- the result surface (ROADMAP C8) ----------------------------------------------


def test_job_result_to_dict_has_the_reference_keys_in_its_order():
    from repro.core.session import JobResult as JResult
    from repro_torch.core.session import JobResult
    kw = dict(history=[{"loss": 1.0}], global_params=None, wall_s=1.0, transport="stacked",
              scheduler="sync")
    want, got = JResult(**kw).to_dict(), JobResult(**kw).to_dict()
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("transport", ["stacked", "thread", "tcp"])
def test_compile_s_is_set_on_every_transport(transport):
    """The seconds before round 0's timed span: the kernels' builds and
    loads on a card, none on the CPU."""
    res = FederatedJob(task=TaskConfig(kind="dose", sites=2, batch=1, volume=(8, 8, 8),
                                       base_filters=4), rounds=1, device="cpu",
                       transport=transport).run()
    assert res.compile_s == 0.0 and res.to_dict()["compile_s"] == 0.0
    assert res.transport == transport


def test_run_takes_rounds_and_resume_by_position(tmp_path):
    """``run(5, True)`` resumes, as the reference's does; ``init_params``
    and ``on_round`` are keyword-only; the stacked transport resumes too,
    and refuses to without a ``checkpoint_dir``, with the reference's
    ``ValueError``."""
    import inspect
    params = inspect.signature(FederatedJob.run).parameters
    assert [p for p in params if params[p].kind is inspect.Parameter.POSITIONAL_OR_KEYWORD] \
        == ["self", "rounds", "resume"]
    assert params["init_params"].kind is params["on_round"].kind is \
        inspect.Parameter.KEYWORD_ONLY
    job = FederatedJob(task=TaskConfig(kind="dose", sites=2, batch=1, volume=(8, 8, 8),
                                       base_filters=4), device="cpu", transport="thread",
                       checkpoint_dir=str(tmp_path), ckpt_every=1)
    job.run(3)
    res = job.run(5, True)
    assert res.resumed_from == 2 and [h["round"] for h in res.history] == [3, 4]
    stacked = job.replace(transport="stacked", checkpoint_dir=str(tmp_path / "stacked"))
    stacked.run(3)
    res = stacked.run(5, True)
    assert res.resumed_from == 2 and [h["round"] for h in res.history] == [3, 4]
    with pytest.raises(ValueError, match="needs checkpoint_dir set"):
        job.replace(transport="stacked", checkpoint_dir=None, ckpt_every=10).run(3, True)
