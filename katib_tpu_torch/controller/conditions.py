"""Trial success and failure conditions — the port's own copy of
``katib_tpu/controller/conditions.py``.

Katib lets a trial define its own success and failure predicates over its
job object, failure checked first, then success, else the default
classification (job_util.go). A trial here has no job object: its terminal
state is its exit code, its outcome, its folded metrics and its stdout, and
a condition is a boolean expression over exactly those, run by an
interpreter of a whitelisted AST (no eval(), no calls):

    exit_code == 0 and metrics["accuracy"] >= 0.9
    "CUDA out of memory" in stdout
    outcome == "completed" and metrics["loss"] < 0.1

Names: ``exit_code`` (int or None), ``outcome`` (completed, failed,
early_stopped or killed), ``metrics`` (metric name -> latest float) and
``stdout`` (the tail of the trial's output). How the controller applies
them: ``controller/executor.py:apply_conditions``.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, Optional

ALLOWED_NAMES = ("exit_code", "outcome", "metrics", "stdout")

_ALLOWED_NODES = (
    ast.Expression,
    ast.BoolOp, ast.And, ast.Or,
    ast.UnaryOp, ast.Not, ast.USub,
    ast.Compare,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.In, ast.NotIn,
    ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div,
    ast.Name, ast.Load, ast.Constant,
    ast.Subscript, ast.Index,  # ast.Index for pre-3.9 compatibility
)


class ConditionError(ValueError):
    """Raised for an invalid condition expression or a failed evaluation."""


def parse_condition(expr: str) -> ast.Expression:
    """Parse + validate a condition expression; raises ConditionError on
    syntax errors, disallowed constructs (calls, attributes, comprehensions,
    lambdas...), or unknown names. Used both at admission (validator) and at
    evaluation time."""
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise ConditionError(f"invalid condition syntax: {e}") from e
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ConditionError(
                f"condition may not contain {type(node).__name__} "
                f"(allowed: comparisons, and/or/not, arithmetic, "
                f"metrics[...] subscripts, string 'in' checks)"
            )
        if isinstance(node, ast.Name) and node.id not in ALLOWED_NAMES:
            raise ConditionError(
                f"unknown name {node.id!r} in condition "
                f"(available: {', '.join(ALLOWED_NAMES)})"
            )
        if isinstance(node, ast.Constant) and not isinstance(
            node.value, (str, int, float, bool, type(None))
        ):
            raise ConditionError(f"unsupported literal {node.value!r} in condition")
    return tree


def evaluate_condition(
    expr: str,
    *,
    exit_code: Optional[int],
    outcome: str,
    metrics: Dict[str, float],
    stdout: str,
) -> bool:
    """Evaluate a parsed condition against the trial's terminal state.
    Raises ConditionError on any evaluation failure (missing metric key,
    type mismatch) — the caller decides what an erroring condition means."""
    tree = parse_condition(expr)
    env = {
        "exit_code": exit_code,
        "outcome": outcome,
        "metrics": metrics,
        "stdout": stdout,
    }

    def ev(node: ast.AST) -> Any:
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            return env[node.id]
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                result = True
                for v in node.values:
                    result = ev(v)
                    if not result:
                        return result
                return result
            result = False
            for v in node.values:
                result = ev(v)
                if result:
                    return result
            return result
        if isinstance(node, ast.UnaryOp):
            operand = ev(node.operand)
            return (not operand) if isinstance(node.op, ast.Not) else -operand
        if isinstance(node, ast.BinOp):
            left, right = ev(node.left), ev(node.right)
            # numeric-only: string Mult/Add would let a short expression
            # allocate unbounded memory in the controller process
            if not isinstance(left, (int, float)) or not isinstance(right, (int, float)):
                raise ConditionError("arithmetic operands must be numeric")
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Mult):
                return left * right
            return left / right
        if isinstance(node, ast.Subscript):
            container = ev(node.value)
            key_node = node.slice
            if isinstance(key_node, ast.Index):  # pre-3.9 AST shape
                key_node = key_node.value
            return container[ev(key_node)]
        if isinstance(node, ast.Compare):
            left = ev(node.left)
            for op, comparator in zip(node.ops, node.comparators):
                right = ev(comparator)
                if isinstance(op, ast.Eq):
                    ok = left == right
                elif isinstance(op, ast.NotEq):
                    ok = left != right
                elif isinstance(op, ast.Lt):
                    ok = left < right
                elif isinstance(op, ast.LtE):
                    ok = left <= right
                elif isinstance(op, ast.Gt):
                    ok = left > right
                elif isinstance(op, ast.GtE):
                    ok = left >= right
                elif isinstance(op, ast.In):
                    ok = left in right
                else:
                    ok = left not in right
                if not ok:
                    return False
                left = right
            return True
        raise ConditionError(f"unsupported node {type(node).__name__}")

    try:
        return bool(ev(tree))
    except ConditionError:
        raise
    except Exception as e:
        raise ConditionError(f"condition {expr!r} failed to evaluate: {e}") from e
