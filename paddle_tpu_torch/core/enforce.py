"""Typed errors and the ``enforce`` helpers (port of
``paddle_tpu/core/enforce.py``): the ``PADDLE_ENFORCE_*`` checks with
typed error codes (reference: ``platform/enforce.h``, ``errors.h``,
``platform/error_codes.proto``). The classes keep the JAX package's
bases, so ``except ValueError`` catches an ``InvalidArgumentError`` in
either package.
"""

from __future__ import annotations

from typing import Any, NoReturn, Sequence


class EnforceNotMet(RuntimeError):
    """Base framework error (reference: platform/enforce.h EnforceNotMet)."""

    code = "LEGACY"


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet, KeyError):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class PermissionDeniedError(EnforceNotMet):
    code = "PERMISSION_DENIED"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


class ExecutionTimeoutError(EnforceNotMet):
    code = "EXECUTION_TIMEOUT"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


def enforce(cond: Any, msg: str = "Enforce failed",
            exc: type = InvalidArgumentError) -> None:
    if not cond:
        raise exc(msg)


def enforce_eq(a: Any, b: Any, msg: str = "") -> None:
    if a != b:
        raise InvalidArgumentError(f"Expected {a!r} == {b!r}. {msg}")


def enforce_gt(a: Any, b: Any, msg: str = "") -> None:
    if not a > b:
        raise InvalidArgumentError(f"Expected {a!r} > {b!r}. {msg}")


def enforce_ge(a: Any, b: Any, msg: str = "") -> None:
    if not a >= b:
        raise InvalidArgumentError(f"Expected {a!r} >= {b!r}. {msg}")


def enforce_in(a: Any, seq: Sequence[Any], msg: str = "") -> None:
    if a not in seq:
        raise InvalidArgumentError(f"Expected {a!r} in {list(seq)!r}. {msg}")


def enforce_shape_match(shape_a, shape_b, msg: str = "") -> None:
    if tuple(shape_a) != tuple(shape_b):
        raise InvalidArgumentError(
            f"Shape mismatch: {tuple(shape_a)} vs {tuple(shape_b)}. {msg}")


def not_implemented(what: str) -> NoReturn:
    raise UnimplementedError(f"{what} is not implemented yet")
