"""Elementwise arithmetic with the JAX package's result types and values.

The frame and series dunders of ``cylon_tpu`` run ``jnp`` ufuncs with
64-bit types enabled; torch promotes differently (``int64 + 1.5`` is
float32 in torch, float64 in JAX) and raises where XLA defines a value
(integer division by zero). This module gives every dunder the JAX
result:

- the result type is the least upper bound on JAX's promotion lattice
  (``jax/_src/dtypes.py``, ``_type_promotion_lattice``), where a Python
  ``int`` or ``float`` is a weak type that yields to the array's kind
  and a Python ``bool`` or a numpy scalar is strong; a weak result is
  int64 or float64;
- true division of a non-floating type takes float64 when the type is
  64-bit or weak and float32 otherwise; floor division, remainder and
  power compute bool as int32;
- integer floor division and remainder follow XLA: ``x // 0`` is -1
  (all bits set for unsigned), ``x % 0`` is 0, ``INT_MIN // -1`` is
  ``INT_MIN``; floats follow ``jnp.floor_divide`` / ``jnp.remainder``;
- a concrete Python integer power runs ``lax.integer_pow``'s binary
  exponentiation (a negative one raises TypeError on integers, as in
  JAX); an array power of integers runs ``jnp.power``'s six-bit
  exponentiation, whose low six exponent bits give a negative
  exponent's value (``2 ** -1`` is ``-2**63`` in int64).
"""

import numbers
import operator

import numpy as np
import torch

from cylon_tpu_torch import device as _device
from cylon_tpu_torch.errors import TypeError_

_NAMES = {
    torch.bool: "b1", torch.uint8: "u8", torch.uint16: "u16",
    torch.uint32: "u32", torch.uint64: "u64", torch.int8: "i8",
    torch.int16: "i16", torch.int32: "i32", torch.int64: "i64",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64",
}
_DTYPES = {v: k for k, v in _NAMES.items()}
#: weak types resolve to the 64-bit defaults
_DTYPES["i*"] = torch.int64
_DTYPES["f*"] = torch.float64

#: JAX's promotion lattice (x64), each type's immediate successors
_LATTICE = {
    "b1": ["i*"], "i*": ["u8", "i8"], "f*": ["bf16", "f16"],
    "u8": ["u16", "i16"], "u16": ["u32", "i32"], "u32": ["u64", "i64"],
    "u64": ["f*"], "i8": ["i16"], "i16": ["i32"], "i32": ["i64"],
    "i64": ["f*"], "bf16": ["f32"], "f16": ["f32"], "f32": ["f64"],
    "f64": [],
}


def _upper_bounds() -> dict:
    out = {}
    for t in _LATTICE:
        seen, todo = {t}, [t]
        while todo:
            for nxt in _LATTICE[todo.pop()]:
                if nxt not in seen:
                    seen.add(nxt)
                    todo.append(nxt)
        out[t] = seen
    return out


_UPPER = _upper_bounds()


def _join(a: str, b: str) -> str:
    common = _UPPER[a] & _UPPER[b]
    least = [t for t in common if common <= _UPPER[t]]
    return least[0]


def _kind(x) -> str:
    """A lattice node for an operand: a tensor's dtype, a numpy scalar's
    dtype, or the weak type of a Python number."""
    if torch.is_tensor(x):
        return _NAMES[x.dtype]
    if isinstance(x, (bool, np.bool_)):
        return "b1"
    if isinstance(x, np.generic):
        return _NAMES[torch.from_numpy(np.asarray(x)).dtype]
    if isinstance(x, numbers.Integral):
        return "i*"
    if isinstance(x, numbers.Real):
        return "f*"
    raise TypeError_(f"unsupported operand {type(x).__name__}")


def _result_node(*operands) -> str:
    node = _kind(operands[0])
    for o in operands[1:]:
        node = _join(node, _kind(o))
    return node


def result_dtype(*operands) -> torch.dtype:
    """The dtype JAX gives an elementwise op of ``operands``."""
    return _DTYPES[_result_node(*operands)]


def _inexact(node: str) -> torch.dtype:
    """``promote_args_inexact``: a non-floating result takes float64 when
    it is 64-bit or weak, float32 otherwise (bool included)."""
    if node in ("i64", "u64", "i*"):
        return torch.float64
    dt = _DTYPES[node]
    return dt if dt.is_floating_point else torch.float32


def _numeric(dt: torch.dtype) -> torch.dtype:
    """``promote_args_numeric``: bool computes as int32."""
    return torch.int32 if dt == torch.bool else dt


def _as(x, dtype: torch.dtype, like: torch.Tensor) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(dtype)
    return _device.scalar(x, dtype, like.device)


def _trunc_divmod(a: torch.Tensor, b: torch.Tensor):
    """XLA's integer ``div`` and ``rem``: truncating, ``x / 0 = -1``,
    ``x % 0 = x`` and ``INT_MIN / -1 = INT_MIN`` (torch raises on a zero
    divisor and traps on ``INT_MIN / -1``)."""
    zero = b == 0
    info = torch.iinfo(a.dtype)
    wrap = (a == info.min) & (b == -1) if info.min < 0 \
        else torch.zeros_like(zero)
    safe = torch.where(zero | wrap, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    r = a - q * safe
    all_ones = -1 if info.min < 0 else info.max
    q = torch.where(zero, torch.full_like(q, all_ones), q)
    r = torch.where(zero, a, torch.where(wrap, torch.zeros_like(r), r))
    return q, r


def _unsigned(dt: torch.dtype) -> bool:
    return dt in (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def floor_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.floor_divide`` on operands of one (non-bool) dtype."""
    if not a.dtype.is_floating_point:
        q, r = _trunc_divmod(a, b)
        if _unsigned(a.dtype):
            return q
        adjust = (torch.sign(a) != torch.sign(b)) & (r != 0)
        return torch.where(adjust, q - 1, q)
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    div = torch.where(ind, div - 1, div)
    # lax.round rounds half away from zero
    return torch.sign(div) * torch.floor(torch.abs(div) + 0.5)


def remainder(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.remainder``: integer divisors of 0 read as 1 (``x % 0`` is
    0), the truncated remainder moved to the divisor's sign."""
    if not a.dtype.is_floating_point:
        b = torch.where(b == 0, torch.ones_like(b), b)
        _, trunc = _trunc_divmod(a, b)
    else:
        trunc = torch.fmod(a, b)
    zero = torch.zeros_like(trunc)
    do_plus = ((trunc < zero) != (b < 0)) & (trunc != zero)
    return torch.where(do_plus, trunc + b, trunc)


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``lax.integer_pow``: binary exponentiation, reciprocal for n < 0."""
    if n < 0 and not x.dtype.is_floating_point:
        raise TypeError(f"Integers cannot be raised to negative powers, "
                        f"got integer_pow({x.dtype}, {n})")
    if n == 0:
        return torch.ones_like(x)
    y, acc = abs(n), None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return 1 / acc if n < 0 else acc


def _pow_int_int(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.power``'s integer path: six steps of binary exponentiation
    over the exponent's low bits (a logical shift, so a negative
    exponent's high bits are never read)."""
    acc = torch.where((x == 0) & (y != 0), torch.zeros_like(x),
                      torch.ones_like(x))
    bits = torch.iinfo(y.dtype).bits
    mask = (1 << bits) - 1
    for _ in range(6):
        acc = torch.where((y & 1) != 0, acc * x, acc)
        x = x * x
        # logical shift right: clear the sign bits an arithmetic shift
        # brings in (the widest case, int64, masks below 2**63)
        y = (y >> 1) & (mask >> 1) if y.dtype.is_signed else y >> 1
    return acc


def power(a, b, reverse: bool = False) -> torch.Tensor:
    """``jnp.power(a, b)`` (``jnp.power(b, a)`` when ``reverse``)."""
    x1, x2 = (b, a) if reverse else (a, b)
    if not torch.is_tensor(x2):
        try:   # a concrete integer exponent, as jnp.power tests it
            n = operator.index(x2)
        except TypeError:
            pass
        else:
            return _integer_pow(x1.to(_numeric(x1.dtype)), n)
    like = a if torch.is_tensor(a) else b
    dt = _numeric(result_dtype(x1, x2))
    p1, p2 = _as(x1, dt, like), _as(x2, dt, like)
    if not dt.is_floating_point:
        return _pow_int_int(p1, p2)
    return torch.pow(p1, p2)


def binary(op: str, a: torch.Tensor, other, reverse: bool = False
           ) -> torch.Tensor:
    """``jnp.<op>(a, other)`` (or ``(other, a)`` when ``reverse``) with
    JAX's result type and values. ``op`` names a ufunc: ``add``,
    ``subtract``, ``multiply``, ``true_divide``, ``floor_divide``,
    ``mod``, ``power``, ``bitwise_and``/``or``/``xor``,
    ``logical_and``/``or``/``xor`` and the six comparisons."""
    if op == "power":
        return power(a, other, reverse)
    node = _result_node(a, other)
    dt = _DTYPES[node]
    if op == "true_divide":
        dt = _inexact(node)
    elif op in ("floor_divide", "mod"):
        dt = _numeric(dt)
    x, y = a.to(dt), _as(other, dt, a)
    if reverse:
        x, y = y, x
    if op == "floor_divide":
        return floor_divide(x, y)
    if op == "mod":
        return remainder(x, y)
    if op.startswith("logical_"):
        x, y = x.to(torch.bool), y.to(torch.bool)
    return _TORCH[op](x, y)


_TORCH = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "true_divide": torch.true_divide, "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or, "bitwise_xor": torch.bitwise_xor,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor, "equal": torch.eq,
    "not_equal": torch.ne, "less": torch.lt, "less_equal": torch.le,
    "greater": torch.gt, "greater_equal": torch.ge,
}


def unary(op: str, a: torch.Tensor) -> torch.Tensor:
    """``jnp.negative`` / ``abs`` / ``invert`` / ``logical_not``."""
    if op == "negative":
        return torch.neg(a)
    if op == "abs":
        return a if a.dtype == torch.bool or _unsigned(a.dtype) \
            else torch.abs(a)
    if op == "invert":
        return torch.bitwise_not(a)
    if op == "logical_not":
        return torch.logical_not(a)
    raise TypeError_(f"unknown unary op {op!r}")
