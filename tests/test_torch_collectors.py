"""The port's metrics collectors against the JAX package's, on the CPU.

- the parsers (katib_tpu_torch/runtime/metrics.py): TEXT lines under the
  default filter and under custom two-group filters, JSON lines and
  Prometheus text give the JAX package's rows for a fixed ``base_time``;
  TF event files written by the JAX package's writer give its rows
  (runtime/tfevent.py), and the port's writer gives the JAX writer's bytes;
- the tailer (runtime/tailer.py), polled over a file written in pieces,
  gives the sequence of ``katib_tpu.native.tailer.PyTailer``;
- ``report_metrics`` prints what the JAX package's prints in a bare process
  and reports to the trial's reporter inside an in-process trial;
- the executor (controller/executor.py): one trial through the JAX
  package's ``SubprocessExecutor`` and its scheduler's condition rule gives
  the port's outcome, exit code, message, metric rows and folded
  observation, for each collector (StdOut, File TEXT with a custom filter,
  File JSON, TfEvent, Custom, Prometheus served by the child) and for the
  conditions (a failure condition on rc 0, a success condition that rescues
  rc 1, an unmet success condition) and a bare rc 3.

Every child is a Python process of the standard library only.
Comparisons are exact. Prometheus rows carry the scrape's wall time, so for
them the values and the folded observation are compared, not the stamps.
"""

import json
import os
import socket
import sys
import textwrap
import threading
import types

import pytest
import torch

from katib_tpu.api import spec as jax_spec
from katib_tpu.api.defaults import set_defaults as jax_set_defaults
from katib_tpu.api.spec import ParameterAssignment as JaxAssignment
from katib_tpu.api.status import Experiment as JaxExperiment
from katib_tpu.api.status import Trial as JaxTrial
from katib_tpu.controller.executor import SubprocessExecutor as JaxExecutor
from katib_tpu.controller.executor import TrialExecution as JaxHandle
from katib_tpu.controller.scheduler import TrialScheduler as JaxScheduler
from katib_tpu.db.store import InMemoryObservationStore as JaxStore
from katib_tpu.native import tailer as jax_tailer
from katib_tpu.runtime import metrics as jax_metrics
from katib_tpu.runtime import tfevent as jax_tfevent
from katib_tpu.runtime.context import TrialContext as JaxContext

from katib_tpu_torch.api import spec
from katib_tpu_torch.api.defaults import set_defaults
from katib_tpu_torch.api.spec import ParameterAssignment
from katib_tpu_torch.api.status import Experiment, Trial
from katib_tpu_torch.controller.executor import SubprocessExecutor, apply_conditions
from katib_tpu_torch.db.store import InMemoryObservationStore
from katib_tpu_torch.runtime import metrics, tailer, tfevent
from katib_tpu_torch.runtime.context import TrialContext

BASE_TIME = 1_700_000_000.0
NAMES = ["loss", "accuracy", "Validation-accuracy", "a|b", "score"]


def _rows(logs):
    return [(r.timestamp, r.metric_name, r.value) for r in logs]


# -- the parsers -------------------------------------------------------------------

TEXT = {
    "default filter": (None, ["epoch=0", "loss=0.5 accuracy=0.8", "loss = 1e-3", "accuracy=+.5", "accuracy=-",
                              "noise loss=abc", "Validation-accuracy=0.9 lr=0.1", "loss=1.0E+2|accuracy=3",
                              "accuracy=", "a|b=2", "score=0.9983777168217213", "score=-1.5e-07 score=4"]),
    "default filter, no match": (None, ["", "nothing here", "loss: 0.5", "LOSS DIVERGED"]),
    "two custom filters": ([r"(\w+):\s*([\d.]+)", r"metric (\S+) is (\S+)"],
                           ["loss: 0.25", "metric accuracy is 0.75", "accuracy=0.1", "metric score is nan",
                            "loss:", "metric Validation-accuracy is 0.5 and loss: 0.125"]),
    "a filter that takes strings": ([r"(Validation-accuracy)=(.*)"], ["Validation-accuracy=Genotype(normal=[])"]),
}


@pytest.mark.parametrize("case", list(TEXT))
def test_text_lines_give_the_jax_packages_rows(case):
    filters, lines = TEXT[case]
    ours = metrics.parse_text_lines(lines, NAMES, filters, base_time=BASE_TIME)
    theirs = jax_metrics.parse_text_lines(lines, NAMES, filters, base_time=BASE_TIME)
    assert _rows(ours) == _rows(theirs)
    assert ours or case.endswith("no match")


JSON_LINES = {
    "numbers and strings": ['{"loss": 0.5, "accuracy": "0.8"}', '{"loss": 1, "epoch": 3}'],
    "timestamps": ['{"loss": 2, "timestamp": 12.5}', '{"accuracy": 0.1, "timestamp": "x"}',
                   '{"accuracy": 0.2, "timestamp": "13"}'],
    "noise": ["not json", "{bad", "   {\"score\": 0.3}  ", "[1, 2]", '{"score": null, "loss": [1]}'],
}


@pytest.mark.parametrize("case", list(JSON_LINES))
def test_json_lines_give_the_jax_packages_rows(case):
    lines = JSON_LINES[case]
    assert _rows(metrics.parse_json_lines(lines, NAMES, base_time=BASE_TIME)) == \
        _rows(jax_metrics.parse_json_lines(lines, NAMES, base_time=BASE_TIME))


PROMETHEUS = {
    "gauges with help and labels": '# HELP accuracy acc\n# TYPE accuracy gauge\naccuracy 0.75\n'
                                   'loss{phase="train"} 0.5 1700000000\nother 1\n',
    "special values": "loss NaN\naccuracy +Inf\nscore -1.5e-3\nscore 2\n",
    "malformed": "loss\naccuracy abc def\n  score   0.25  \n{x} 1\n",
}


@pytest.mark.parametrize("case", list(PROMETHEUS))
def test_prometheus_text_gives_the_jax_packages_rows(case):
    text = PROMETHEUS[case]
    assert _rows(metrics.parse_prometheus_text(text, NAMES, base_time=BASE_TIME)) == \
        _rows(jax_metrics.parse_prometheus_text(text, NAMES, base_time=BASE_TIME))


EVENTS = {
    "scalars by step": [(0, {"loss": 0.5, "accuracy": 0.25}), (1, {"loss": 0.25}), (2, {"accuracy": 0.75})],
    "tags with a path": [(0, {"train/loss": 1.5, "eval/accuracy": 0.125, "unwanted": 3.0})],
}


@pytest.mark.parametrize("case", list(EVENTS))
def test_tf_events_of_the_jax_writer_give_the_jax_packages_rows(case, tmp_path):
    jax_tfevent.write_scalar_events(str(tmp_path / "jax"), EVENTS[case], filename="events.out.tfevents.1.jax")
    ours = tfevent.collect_tfevent_metrics(str(tmp_path / "jax"), NAMES)
    assert ours and _rows(ours) == _rows(jax_tfevent.collect_tfevent_metrics(str(tmp_path / "jax"), NAMES))
    assert list(tfevent.read_tfevents(next((tmp_path / "jax").iterdir()).as_posix())) == \
        list(jax_tfevent.read_tfevents(next((tmp_path / "jax").iterdir()).as_posix()))


def test_the_port_writes_the_jax_writers_bytes():
    for step, scalars in EVENTS["scalars by step"]:
        assert tfevent.encode_scalar_event(BASE_TIME + step, step, scalars) == \
            jax_tfevent.encode_scalar_event(BASE_TIME + step, step, scalars)
    for data in (b"", b"a", b"123456789", bytes(range(256))):
        assert tfevent._masked_crc(data) == jax_tfevent._masked_crc(data)


# -- the tailer ----------------------------------------------------------------------

TAILED = {  # (filters, json, pieces written between polls)
    "TEXT, lines in pieces": (None, False, ["loss=0.", "5\naccu", "racy=0.9\nepoch=1\n", "", "loss=+\nloss=0.25",
                                            "\n"]),
    "custom filter": ([r"metric (\w+) is (\S+)"], False, ["metric loss is 1.5\nmetric acc", "uracy is 0.5\n"]),
    "JSON": (None, True, ['{"loss": 0.5}\n{"accu', 'racy": 0.75, "timestamp": 3}\n', 'noise\n{"loss": "x"}\n']),
}


@pytest.mark.parametrize("case", list(TAILED))
def test_the_tailer_polls_as_the_jax_python_tailer(case, tmp_path):
    filters, json_format, pieces = TAILED[case]
    path = tmp_path / "stdout.log"
    ours = tailer.make_tailer(str(path), NAMES, filters, json_format)
    theirs = jax_tailer.PyTailer(str(path), NAMES, filters, json_format)
    seen = [(ours.poll(), theirs.poll())]  # before the file exists
    for piece in pieces:
        with open(path, "a") as f:
            f.write(piece)
        seen.append((ours.poll(), theirs.poll()))
    assert [a for a, _ in seen] == [b for _, b in seen]
    assert any(a for a, _ in seen)


# -- report_metrics ------------------------------------------------------------------

def test_report_metrics_prints_the_jax_packages_lines(capsys, monkeypatch):
    for key in ("KATIB_TPU_TRIAL_NAME", "KATIB_TPU_DB_PATH", "KATIB_TPU_RPC_URL", "KATIB_TPU_INGEST_ADDR"):
        monkeypatch.delenv(key, raising=False)
    values = {"loss": 0.5, "accuracy": 1, "score": True}
    jax_metrics.report_metrics(values, extra="2.5")
    theirs = capsys.readouterr().out
    metrics.report_metrics(values, extra="2.5")
    assert capsys.readouterr().out == theirs == "loss=0.5\naccuracy=1.0\nscore=1.0\nextra=2.5\n"
    with pytest.raises(ValueError, match="not convertible"):
        metrics.report_metrics(loss="nan-ish")


def test_report_metrics_in_an_in_process_trial_reaches_its_reporter():
    store = InMemoryObservationStore()
    with metrics.current_reporter(metrics.MetricsReporter(store, "t")):
        metrics.report_metrics({"loss": 0.5}, accuracy=0.25)
    assert [(r.metric_name, r.value) for r in store.get_observation_log("t")] == [("loss", "0.5"), ("accuracy", "0.25")]


# -- the executor against the JAX package's -------------------------------------------

def _child(body):
    return [sys.executable, "-c", textwrap.dedent(body)]


PROMETHEUS_CHILD = """
    import http.server, sys
    class Metrics(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = b'# TYPE accuracy gauge\\naccuracy 0.75\\nloss{phase="train"} 0.5\\nother 1\\n'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        def log_message(self, *args):
            pass
    server = http.server.HTTPServer(("127.0.0.1", int(sys.argv[1])), Metrics)
    server.handle_request()  # one scrape, then exit
"""

STDOUT_LINES = "print('epoch=0'); print('loss=0.5'); print('accuracy=0.8'); print('loss=0.25'); print('accuracy=0.9')"

CASES = {  # name: (command, metricsCollectorSpec or None, trial-template extras)
    "StdOut": (_child(STDOUT_LINES), None, {}),
    "File TEXT, custom filter": (
        _child("import os\nwith open(os.environ['KATIB_TPU_METRICS_FILE'], 'w') as f:\n"
               "    f.write('metric loss is 0.5\\nmetric accuracy is 0.625\\naccuracy=0.1\\n')\nprint('loss=9')"),
        {"collector": {"kind": "File"}, "source": {"filePath": "metrics.txt", "filter": {
            "metricsFormat": [r"metric (\w+) is (\S+)"]}}}, {}),
    "File JSON": (
        _child("import json, os\nwith open(os.environ['KATIB_TPU_METRICS_FILE'], 'w') as f:\n"
               "    f.write(json.dumps({'loss': 0.5, 'accuracy': 0.25}) + '\\nnoise\\n'"
               " + json.dumps({'accuracy': '0.5', 'timestamp': 5}) + '\\n')"),
        {"collector": {"kind": "File"}, "source": {"filePath": "metrics.jsonl", "fileFormat": "JSON"}}, {}),
    "TfEvent": (_child("print('events written beforehand')"), "tfevent", {}),
    "Custom": (
        _child("print('raw 0.4'); print('raw 0.3')"),
        {"collector": {"kind": "Custom", "customCollector": {"command": _child(
            "import os\nfor i, line in enumerate(open(os.environ['KATIB_TRIAL_STDOUT'])):\n"
            "    print(f\"accuracy={2 * float(line.split()[1])}\")\nprint(f\"loss={len(os.environ['KATIB_TRIAL_WORKDIR']) > 0}\")"
        )}}}, {}),
    "Prometheus": ("prometheus", {"collector": {"kind": "PrometheusMetric"}}, {}),
    "failure condition on rc 0": (_child("print('LOSS DIVERGED'); print('accuracy=0.9')"), None,
                                  {"failureCondition": "'LOSS DIVERGED' in stdout",
                                   "successCondition": "metrics['accuracy'] > 0.5"}),
    "success condition rescues rc 1": (_child("import sys; print('accuracy=0.9'); sys.exit(1)"), None,
                                       {"successCondition": "metrics['accuracy'] > 0.5"}),
    "unmet success condition": (_child("print('accuracy=0.1')"), None,
                                {"successCondition": "exit_code == 0 and metrics['accuracy'] > 0.5"}),
    "rc 3, no conditions": (_child("import sys; print('accuracy=0.3', flush=True); sys.exit(3)"), None, {}),
}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _doc(case, tmp_path):
    command, collector, extras = CASES[case]
    doc = {"name": "collect", "parameters": [{"name": "lr", "parameterType": "double",
                                              "feasibleSpace": {"min": "0.01", "max": "0.5"}}],
           "objective": {"type": "maximize", "objectiveMetricName": "accuracy", "additionalMetricNames": ["loss"]},
           "algorithm": {"algorithmName": "random"}, "maxTrialCount": 1,
           "trialTemplate": dict({"command": command}, **extras)}
    if collector == "tfevent":
        events = tmp_path / "events"
        jax_tfevent.write_scalar_events(str(events), [(0, {"accuracy": 0.5, "train/loss": 1.25}),
                                                      (1, {"accuracy": 0.625})], filename="events.out.tfevents.1.x")
        collector = {"collector": {"kind": "TfEvent"}, "source": {"filePath": str(events)}}
    if collector is not None:
        doc["metricsCollectorSpec"] = collector
    return doc


def _with_port(doc, command):
    """A Prometheus case's doc and command on a free port of its own."""
    if command != "prometheus":
        return doc
    port = _free_port()
    doc = json.loads(json.dumps(doc))
    doc["trialTemplate"]["command"] = _child(PROMETHEUS_CHILD) + [str(port)]
    doc["metricsCollectorSpec"]["source"] = {"httpGet": {"host": "127.0.0.1", "port": port, "path": "/metrics"}}
    return doc


def _run_jax(doc, workdir):
    s = jax_set_defaults(jax_spec.ExperimentSpec.from_dict(doc))
    trial = JaxTrial(name="collect-1", experiment_name="collect", parameter_assignments=[JaxAssignment("lr", "0.1")],
                     start_time=BASE_TIME)
    store = JaxStore()
    ctx = JaxContext(trial_name=trial.name, experiment_name="collect", assignments=trial.assignments_dict(),
                     reporter=jax_metrics.MetricsReporter(store=store, trial_name=trial.name), workdir=str(workdir))
    result = JaxExecutor(store).execute(JaxExperiment(spec=s), trial, ctx, JaxHandle())
    observation = store.folded(trial.name, s.objective.all_metric_names())
    result = JaxScheduler._apply_conditions(
        types.SimpleNamespace(CONDITION_STDOUT_TAIL=JaxScheduler.CONDITION_STDOUT_TAIL),
        JaxExperiment(spec=s), result, observation)
    return result, store.get_observation_log(trial.name), observation


def _run_port(doc, workdir):
    s = set_defaults(spec.ExperimentSpec.from_dict(doc))
    trial = Trial(name="collect-1", experiment_name="collect", parameter_assignments=[ParameterAssignment("lr", "0.1")],
                  start_time=BASE_TIME)
    store = InMemoryObservationStore()
    ctx = TrialContext(trial_name=trial.name, experiment_name="collect", assignments=trial.assignments_dict(),
                       reporter=metrics.MetricsReporter(store, trial.name), devices=[torch.device("cpu")],
                       workdir=str(workdir))
    result = SubprocessExecutor(store).execute(Experiment(spec=s), trial, ctx, threading.Event())
    observation = store.folded(trial.name, s.objective.all_metric_names())
    return apply_conditions(s.trial_template, result, observation), store.get_observation_log(trial.name), observation


@pytest.mark.parametrize("case", list(CASES))
def test_a_trial_through_the_executor_ends_as_through_the_jax_packages(case, tmp_path):
    doc = _doc(case, tmp_path)
    theirs = _run_jax(_with_port(doc, CASES[case][0]), tmp_path / "jax")
    ours = _run_port(_with_port(doc, CASES[case][0]), tmp_path / "port")
    (r1, logs1, obs1), (r2, logs2, obs2) = ours, theirs
    assert (r1.outcome.value, r1.exit_code, r1.message) == (r2.outcome.value, r2.exit_code, r2.message)
    assert obs1.to_dict() == obs2.to_dict()
    if case == "Prometheus":
        assert [(r.metric_name, r.value) for r in logs1] == [(r.metric_name, r.value) for r in logs2]
    else:
        assert _rows(logs1) == _rows(logs2)
    assert logs1 or case == "unmet success condition"
    assert os.path.exists(tmp_path / "port" / "stdout.log")
