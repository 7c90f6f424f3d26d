"""Status/Result error model.

Mirrors the role of yb::Status / yb::Result (ref: src/yb/util/status.h) but
idiomatically Pythonic: a Status is a lightweight value describing an error
category + message; StatusError is the exception wrapper used where the
reference would propagate a bad Status up the stack.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import TypeVar, Union

T = TypeVar("T")


class Code(enum.Enum):
    OK = 0
    NOT_FOUND = 1
    CORRUPTION = 2
    NOT_SUPPORTED = 3
    INVALID_ARGUMENT = 4
    IO_ERROR = 5
    ALREADY_PRESENT = 6
    RUNTIME_ERROR = 7
    NETWORK_ERROR = 8
    ILLEGAL_STATE = 9
    NOT_AUTHORIZED = 10
    ABORTED = 11
    REMOTE_ERROR = 12
    SERVICE_UNAVAILABLE = 13
    TIMED_OUT = 14
    UNINITIALIZED = 15
    CONFIGURATION_ERROR = 16
    INCOMPLETE = 17
    END_OF_FILE = 18
    INTERNAL_ERROR = 19
    EXPIRED = 20
    LEADER_NOT_READY = 21
    LEADER_HAS_NO_LEASE = 22
    TRY_AGAIN = 23
    BUSY = 24
    SHUTDOWN_IN_PROGRESS = 25
    MERGE_IN_PROGRESS = 26


@dataclass(frozen=True)
class Status:
    code: Code = Code.OK
    message: str = ""

    @property
    def ok(self) -> bool:
        return self.code == Code.OK

    def __str__(self) -> str:
        return "OK" if self.ok else f"{self.code.name}: {self.message}"

    @staticmethod
    def OK() -> "Status":
        return _OK

    def raise_if_error(self) -> None:
        if not self.ok:
            raise StatusError(self)


_OK = Status()


def _mk(code: Code):
    @staticmethod
    def ctor(message: str = "") -> Status:
        return Status(code, message)

    return ctor


for _code in Code:
    if _code != Code.OK:
        name = "".join(p.capitalize() for p in _code.name.split("_"))
        setattr(Status, name, _mk(_code))


class StatusError(Exception):
    """Exception carrying a Status; raised where the reference returns a bad Status."""

    def __init__(self, status: Status):
        super().__init__(str(status))
        self.status = status


Result = Union[T, Status]  # documentation alias for yb::Result<T>
