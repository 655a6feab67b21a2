"""The training CLI (``repro_torch.launch.train``) against the reference's
``repro/launch/train.py``.

- The parser: every flag and default of the reference's, plus ``--device``
  (default None: the card).
- ``--dry-run`` prints the reference's resolved dict, key for key, for a
  set of argvs (no job runs in either package).
- ``--task tokens``, the reference's default, trains (test_torch_tokens.py
  runs it); an architecture the port has not got raises
  ``NotPorted("arch")``.
- A tiny ``--task dose --device cpu`` run writes ``train_<strategy>.json``
  equal to ``FederatedJob.run().to_dict()`` of the same job but for the
  times; ``--checkpoint --resume`` re-enters from the newest checkpoint.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.launch import train as jtrain  # noqa: E402
from repro_torch import NotPorted  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

TINY_ARGS = ["--task", "dose", "--sites", "3", "--rounds", "2", "--volume", "8",
             "--base-filters", "4", "--batch", "1", "--quiet", "--device", "cpu"]
TIMES = ("wall_s", "batch_s", "step_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_parser_has_the_reference_flags_and_defaults():
    got = vars(ttrain.make_parser().parse_args([]))
    want = vars(jtrain.make_parser().parse_args([]))
    assert got.pop("device") is None
    assert got == want


ARGVS = [
    [],
    ["--task", "dose", "--strategy", "gcml", "--sites", "5", "--max-dropout", "2",
     "--device-data"],
    ["--task", "seg", "--sites", "64", "--sample", "uniform:4", "--dropout-scenario",
     "shutdown", "--shard-sites", "--compression", "int8"],
    ["--task", "dose", "--transport", "tcp", "--compression", "int8", "--down-compression",
     "int8", "--topology", "pods:2", "--pod-dropout", "1"],
    ["--scheduler", "buffered", "--buffer-k", "3", "--compression", "topk", "--aggregator",
     "trimmed:1", "--adversary", "sign_flip:1", "--round-engine", "loop",
     "--chunk-rounds", "4"],
    ["--dp-clip", "0.5", "--dp-noise-multiplier", "0.8", "--dp-mode", "per-example",
     "--secure-agg", "--transport", "thread", "--auth-secret", "s", "--max-message-size",
     "4096", "--lease-ttl", "5", "--round-deadline-s", "3", "--max-upload-norm", "10",
     "--resume", "--checkpoint", "--out", "runs/x"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a[:4]) or "defaults")
def test_dry_run_prints_the_reference_dict(argv, capsys):
    want = jtrain.run(jtrain.make_parser().parse_args(argv + ["--dry-run"]))
    want_out = capsys.readouterr().out
    got = ttrain.run(ttrain.make_parser().parse_args(argv + ["--dry-run", "--device", "cpu"]))
    got_out = capsys.readouterr().out
    assert got == want
    assert json.loads(got_out) == json.loads(want_out)
    assert list(got) == list(want)


def test_task_tokens_raises_not_ported():
    """The token task runs now; what it cannot train is an architecture the
    port has not got (since every token architecture was ported,
    sanet-openkbp, which is not a token model), and that raises before any
    round."""
    args = ttrain.make_parser().parse_args(["--device", "cpu", "--rounds", "1",
                                            "--arch", "sanet-openkbp", "--reduced"])
    with pytest.raises(NotPorted) as err:
        ttrain.run(args)
    assert err.value.seam == "arch"


def _untimed(d):
    return {**d, "wall_s": None, "compile_s": None,
            "history": [{k: v for k, v in h.items() if k not in TIMES} for h in d["history"]]}


def test_dose_run_writes_the_job_result(tmp_path):
    out = ttrain.run(ttrain.make_parser().parse_args(TINY_ARGS + ["--out", str(tmp_path)]))
    written = json.loads((tmp_path / "train_fedavg.json").read_text())
    job = FederatedJob(task=TaskConfig(kind="dose", sites=3, batch=1, volume=(8, 8, 8),
                                       base_filters=4, num_levels=2), rounds=2, device="cpu")
    want = {**job.run().to_dict(), "strategy": "fedavg"}
    assert _untimed(written) == _untimed(json.loads(json.dumps(out))) == \
        _untimed(json.loads(json.dumps(want)))
    assert np.isfinite(written["final_loss"])


def test_checkpoint_and_resume(tmp_path):
    argv = TINY_ARGS + ["--out", str(tmp_path), "--checkpoint", "--ckpt-every", "1"]
    ttrain.run(ttrain.make_parser().parse_args(argv))
    res = ttrain.run(ttrain.make_parser().parse_args(argv + ["--rounds", "3", "--resume"]))
    assert res["resumed_from"] == 1
    assert [h["round"] for h in res["history"]] == [2]
