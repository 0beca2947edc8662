"""Canvas sizes (`vismut_core/src/slot_data.rs:5-30`)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Size:
    width: int
    height: int

    @staticmethod
    def new(width: int, height: int) -> "Size":
        return Size(int(width), int(height))

    def pixel_count(self) -> int:
        return self.width * self.height

    def __str__(self) -> str:
        return f"{self.width}x{self.height}"
