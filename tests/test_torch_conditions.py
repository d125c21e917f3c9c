"""The port's trial conditions against the JAX package's, on the CPU.

- ``parse_condition`` and ``evaluate_condition``
  (katib_tpu_torch/controller/conditions.py) give the JAX package's value,
  or its ConditionError with the same message, for a table of expressions
  over three terminal states, and for random strings (hypothesis);
- the condition rule (katib_tpu_torch/controller/executor.py:
  apply_conditions) gives the outcome, message and exit code of the JAX
  scheduler's ``_apply_conditions`` for a table of templates and results.

Everything is compared exactly: strings, messages, outcomes.
"""

import types

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from katib_tpu.api.spec import Metric as JaxMetric
from katib_tpu.api.spec import Observation as JaxObservation
from katib_tpu.api.spec import TrialTemplate as JaxTrialTemplate
from katib_tpu.controller import conditions as jax_conditions
from katib_tpu.controller.executor import ExecutionResult as JaxResult
from katib_tpu.controller.executor import TrialOutcome as JaxOutcome
from katib_tpu.controller.scheduler import TrialScheduler as JaxScheduler
from katib_tpu_torch.api.spec import Metric, Observation, TrialTemplate
from katib_tpu_torch.controller import conditions
from katib_tpu_torch.controller.executor import ExecutionResult, TrialOutcome, apply_conditions

STATES = [
    dict(exit_code=0, outcome="completed", metrics={"accuracy": 0.92, "loss": 0.08},
         stdout="epoch 3 done\naccuracy=0.92\n"),
    dict(exit_code=1, outcome="failed", metrics={}, stdout="Traceback ...\nCUDA out of memory\n"),
    dict(exit_code=None, outcome="killed", metrics={"loss": float("nan")}, stdout=""),
]

EXPRESSIONS = [
    "exit_code == 0",
    "exit_code != 0",
    "exit_code == 0 and metrics['accuracy'] >= 0.9",
    "metrics['accuracy'] >= 0.95",
    "metrics['loss'] < 0.1 or exit_code != 0",
    "'epoch 3 done' in stdout",
    "'OOM' not in stdout",
    "'CUDA out of memory' in stdout",
    "outcome == 'completed'",
    "outcome in 'completed failed'",
    "0.0 < metrics['accuracy'] < 1.0",
    "metrics['accuracy'] - metrics['loss'] > 0.8",
    "metrics['accuracy'] * 2 + 1 > 2.5",
    "metrics['accuracy'] / 0",
    "metrics['loss'] / 2 <= 0.04",
    "-metrics['loss'] < 0",
    "not exit_code",
    "not (exit_code == 0 and outcome == 'completed')",
    "exit_code is None",
    "exit_code == None",
    "exit_code > 0",
    "stdout * 3",
    "stdout + 'x'",
    "metrics['missing'] > 1",
    "metrics[0]",
    "'loss' in metrics",
    "metrics",
    "stdout",
    "True",
    "1 and 0",
    "0 or 'fallback'",
    "__import__('os')",
    "open('/etc/passwd')",
    "stdout.upper()",
    "[x for x in stdout]",
    "lambda: 1",
    "b'bytes' in stdout",
    "result == 1",
    "metrics['accuracy'] ** 2",
    "exit_code == ",
    "(",
    "",
    "1 if exit_code else 0",
    "{'a': 1}",
    "metrics['accuracy'] > 0.9 and 'done' in stdout and outcome != 'failed'",
]


def _call(module, fn, *args, **kwargs):
    try:
        return ("value", getattr(module, fn)(*args, **kwargs))
    except module.ConditionError as e:
        return ("error", str(e))


def _evaluations(module, expr):
    out = [_call(module, "evaluate_condition", expr, **state) for state in STATES]
    parsed = _call(module, "parse_condition", expr)
    return out, parsed[0] if parsed[0] == "value" else parsed


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_expressions_evaluate_as_in_the_jax_package(expr):
    assert _evaluations(conditions, expr) == _evaluations(jax_conditions, expr)


TOKENS = ["exit_code", "outcome", "metrics", "stdout", "['loss']", "['accuracy']", "'done'", "0", "1", "0.5",
          "==", "!=", "<", ">=", " and ", " or ", "not ", " in ", " not in ", "+", "-", "*", "/", "(", ")",
          "[", "]", " ", "'", "x", ".", "None", "True", "lambda", ":", ","]


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=list(HealthCheck))
@given(st.one_of(st.lists(st.sampled_from(TOKENS), max_size=12).map("".join), st.text(max_size=30)))
def test_random_strings_give_the_jax_packages_value_or_message(expr):
    assert _evaluations(conditions, expr) == _evaluations(jax_conditions, expr)


# -- the condition rule ------------------------------------------------------------

SUCCESS = "exit_code == 0 and metrics['score'] > 0.5"
FAILURE = "'LOSS DIVERGED' in stdout"
RULES = {  # name: (success condition, failure condition, outcome, exit code, message, score, stdout)
    "no conditions": ("", "", "completed", 0, "", 0.9, "score=0.9\n"),
    "both met: failure first": (SUCCESS, FAILURE, "completed", 0, "", 0.9, "LOSS DIVERGED\n"),
    "failure on rc 0": ("", FAILURE, "completed", 0, "", None, "LOSS DIVERGED\n"),
    "failure not met": ("", FAILURE, "completed", 0, "", 0.9, "score=0.9\n"),
    "success rescues rc 1": ("metrics['score'] > 0.5", "", "failed", 1, "process exited with code 1", 0.9,
                             "score=0.9\n"),
    "success not met keeps the message": (SUCCESS, "", "failed", 1, "process exited with code 1", 0.9, ""),
    "success not met, no message": (SUCCESS, "", "completed", 0, "", 0.2, "score=0.2\n"),
    "success met": (SUCCESS, FAILURE, "completed", 0, "", 0.7, "score=0.7\n"),
    "success errs on a missing metric": (SUCCESS, "", "completed", 0, "", None, ""),
    "failure errs, success met": ("exit_code == 0", "metrics['nope'] > 1", "completed", 0, "", None, ""),
    "killed is left alone": (SUCCESS, FAILURE, "killed", -15, "kill requested", None, "LOSS DIVERGED\n"),
    "early stopped is left alone": (SUCCESS, FAILURE, "early_stopped", -15, "", 0.1, ""),
    "program never started": (SUCCESS, FAILURE, "failed", None, "FileNotFoundError: x", None, None),
    "stdout tail only": ("", "'HEAD' in stdout", "completed", 0, "", None, "HEAD\n" + "x" * 70000),
}


@pytest.mark.parametrize("case", list(RULES))
def test_the_condition_rule_is_the_jax_schedulers(case, tmp_path):
    success, failure, outcome, exit_code, message, score, stdout = RULES[case]
    path = None
    if stdout is not None:
        path = tmp_path / "stdout.log"
        path.write_text(stdout)
        path = str(path)
    metrics = [] if score is None else [("score", repr(score))]
    ours = apply_conditions(
        TrialTemplate(command=["x"], success_condition=success, failure_condition=failure),
        ExecutionResult(TrialOutcome(outcome), message, exit_code=exit_code, stdout_path=path),
        Observation([Metric(n, min=v, max=v, latest=v) for n, v in metrics]))
    theirs = JaxScheduler._apply_conditions(
        types.SimpleNamespace(CONDITION_STDOUT_TAIL=JaxScheduler.CONDITION_STDOUT_TAIL),
        types.SimpleNamespace(spec=types.SimpleNamespace(trial_template=JaxTrialTemplate(
            command=["x"], success_condition=success, failure_condition=failure))),
        JaxResult(JaxOutcome(outcome), message, exit_code=exit_code, stdout_path=path),
        JaxObservation([JaxMetric(n, min=v, max=v, latest=v) for n, v in metrics]))
    assert (ours.outcome.value, ours.message, ours.exit_code, ours.stdout_path) == \
        (theirs.outcome.value, theirs.message, theirs.exit_code, theirs.stdout_path)
