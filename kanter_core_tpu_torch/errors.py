"""Error model.

Mirrors the reference error enum (`vismut_core/src/error.rs:3-27`): one
exception type carrying an `ErrorKind` discriminant, with equality defined on
the discriminant only (reference: discriminant-only `PartialEq`,
`error.rs:29-33`).
"""

from __future__ import annotations

import enum


class ErrorKind(enum.Enum):
    GENERIC = "Generic"
    CANCELED = "Canceled"
    IMAGE = "Image"
    INVALID_BUFFER_COUNT = "InvalidBufferCount"
    INVALID_NODE_ID = "InvalidNodeId"
    INVALID_NODE_TYPE = "InvalidNodeType"
    INVALID_SLOT_ID = "InvalidSlotId"
    INVALID_SLOT_TYPE = "InvalidSlotType"
    INVALID_EDGE = "InvalidEdge"
    NO_SLOT_DATA = "NoSlotData"
    SLOT_OCCUPIED = "SlotOccupied"
    SLOT_NOT_OCCUPIED = "SlotNotOccupied"
    UNABLE_TO_LOCK = "UnableToLock"
    NODE_PROCESSING = "NodeProcessing"
    POISON_ERROR = "PoisonError"
    TRY_LOCK_ERROR = "TryLockError"
    NODE_DIRTY = "NodeDirty"
    IO = "Io"
    INVALID_NAME = "InvalidName"
    # extension: device-capacity failure that could not be row-banded away
    # (no reference counterpart — the reference aborts the process on any
    # allocation failure; here the error is graph-fatal but the processor
    # and its other live graphs keep running)
    RESOURCE_EXHAUSTED = "ResourceExhausted"


_MESSAGES = {
    ErrorKind.GENERIC: "Something went wrong",
    ErrorKind.CANCELED: "Node processing was canceled",
    ErrorKind.IMAGE: "Image error",
    ErrorKind.INVALID_BUFFER_COUNT: "Invalid number of channels",
    ErrorKind.INVALID_NODE_ID: "Invalid `NodeId`",
    ErrorKind.INVALID_NODE_TYPE: "Invalid `NodeType`",
    ErrorKind.INVALID_SLOT_ID: "Invalid `SlotId`",
    ErrorKind.INVALID_SLOT_TYPE: "Invalid `SlotType`",
    ErrorKind.INVALID_EDGE: "Invalid `Edge`",
    ErrorKind.NO_SLOT_DATA: "Could not find a `SlotData`",
    ErrorKind.SLOT_OCCUPIED: "`SlotId` is already in use",
    ErrorKind.SLOT_NOT_OCCUPIED: "`SlotId` is not in use",
    ErrorKind.UNABLE_TO_LOCK: "Unable to get a lock",
    ErrorKind.NODE_PROCESSING: "Error during node processing",
    ErrorKind.POISON_ERROR: "Error with poisoned lock",
    ErrorKind.TRY_LOCK_ERROR: "Error when trying to lock",
    ErrorKind.NODE_DIRTY: "The node is not up to date",
    ErrorKind.IO: "IO error",
    ErrorKind.INVALID_NAME: (
        "Invalid name, can only contain lowercase letters, numbers and underscores"
    ),
}


class TexProError(Exception):
    """Framework error; compares equal to another error of the same kind."""

    def __init__(self, kind: ErrorKind, message: str | None = None):
        self.kind = kind
        super().__init__(message or _MESSAGES.get(kind, str(kind)))

    def __eq__(self, other):
        if isinstance(other, TexProError):
            return self.kind == other.kind
        if isinstance(other, ErrorKind):
            return self.kind == other
        return NotImplemented

    def __hash__(self):
        return hash(self.kind)


# Convenience constructors so call sites read like the reference enum.
def generic(msg: str | None = None) -> TexProError:
    return TexProError(ErrorKind.GENERIC, msg)


def canceled() -> TexProError:
    return TexProError(ErrorKind.CANCELED)
