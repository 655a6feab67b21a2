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


@pytest.mark.parametrize("seam,kw", [
    ("scheduler", dict(scheduler="buffered")),
    ("strategy", dict(strategy="fedprox", transport="thread")),
    ("compression", dict(compression="fp8")),
    ("down_compression", dict(down_compression="topk-fixed")),
    ("dp", dict(dp_clip=1.0)),
    ("device_data", dict(device_data=True)),
    ("adversary", dict(adversary="noise:1:1")),
    ("strategy", dict(strategy="fedprox", aggregator="median", transport="thread")),
    ("topology", dict(topology="pods:2", aggregator="median")),
    ("topology", dict(topology="pods:2")),
    ("shard_sites", dict(shard_sites=True)),
    ("task", dict(task=TaskConfig(kind="tokens"))),
    ("strategy", dict(compression="int8", strategy="gcml", transport="tcp")),
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


# fields of the reference's job and task that name an unported seam:
# (field, a value other than the default, the seam NotPorted names)
FIELDS = [
    ("dp_clip", 1.0, "dp"), ("dp_noise_multiplier", 1.0, "dp"),
    ("pod_dropout", 1, "topology"), ("device_data", True, "device_data"),
    ("dp_delta", 1e-6, "dp"), ("dp_mode", "per-example", "dp"),
    ("round_engine", "loop", "round_engine"),
    ("chunk_rounds", 2, "round_engine"), ("ckpt_every", 5, "checkpoint"),
    ("task.arch", "gemma3-1b", "task"), ("task.reduced", False, "task"),
    ("task.seq", 32, "task"), ("checkpoint_dir", "ckpt", "checkpoint"),
    ("shard_sites", True, "shard_sites"),
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
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"
        assert "import jax" not in f.read_text(), f


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; chip_smoke.py would run in full")
    import subprocess
    import sys
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
