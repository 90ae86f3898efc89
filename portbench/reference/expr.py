"""Size-expression evaluator: the benchmark's frozen copy of
``transform360_tpu_torch/utils/expr.py``.

Tiny safe arithmetic-expression evaluator for ffmpeg-style size strings.

The reference evaluates ``w``/``h`` option expressions with
``av_expr_parse_and_eval`` over the variables ``out_w/ow/out_h/oh``
(``vf_transform360.c:30-32,228-287``).  We support the arithmetic subset
actually useful for sizing (numbers, + - * / parentheses, the four
variables, and the common av_expr helpers floor/ceil/trunc/round/min/max).
Unresolved variables evaluate to NaN, like av_expr's NAN-initialized
variables, so the reference's "evaluate w, then h, then w again" dance
works identically.
"""

from __future__ import annotations

import ast
import math
from typing import Optional

_FUNCS = {
    "floor": math.floor,
    "ceil": math.ceil,
    "trunc": math.trunc,
    "round": round,
    "min": min,
    "max": max,
    "abs": abs,
    "sqrt": math.sqrt,
    "pow": pow,
    "mod": math.fmod,
}

_ALLOWED_BINOPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.Mod)
_ALLOWED_UNARY = (ast.UAdd, ast.USub)


def _eval_node(node, names):
    if isinstance(node, ast.Expression):
        return _eval_node(node.body, names)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float)):
            return float(node.value)
        raise ValueError(f"bad constant {node.value!r}")
    if isinstance(node, ast.Name):
        if node.id in names:
            return names[node.id]
        raise ValueError(f"unknown variable {node.id!r}")
    if isinstance(node, ast.BinOp) and isinstance(node.op, _ALLOWED_BINOPS):
        left = _eval_node(node.left, names)
        right = _eval_node(node.right, names)
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.Mult):
            return left * right
        if isinstance(node.op, ast.Div):
            return left / right
        if isinstance(node.op, ast.Pow):
            return left**right
        if isinstance(node.op, ast.Mod):
            return math.fmod(left, right)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, _ALLOWED_UNARY):
        v = _eval_node(node.operand, names)
        return v if isinstance(node.op, ast.UAdd) else -v
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        fn = _FUNCS.get(node.func.id)
        if fn is None:
            raise ValueError(f"unknown function {node.func.id!r}")
        args = [_eval_node(a, names) for a in node.args]
        return float(fn(*args))
    raise ValueError(f"unsupported expression element {ast.dump(node)}")


def eval_expr(expr: str, **variables) -> float:
    """Evaluate an arithmetic expression with the given variables."""
    tree = ast.parse(expr, mode="eval")
    return float(_eval_node(tree, variables))


def eval_size_expr(
    expr: str, out_w: Optional[float], out_h: Optional[float]
) -> float:
    """Evaluate a w/h option expression with out_w/ow/out_h/oh bindings."""
    w = math.nan if out_w is None else float(out_w)
    h = math.nan if out_h is None else float(out_h)
    return eval_expr(expr, out_w=w, ow=w, out_h=h, oh=h)
