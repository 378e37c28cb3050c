"""The film's PNG writer: io/png.py's."""
from ..io.png import write_png

__all__ = ["write_png"]
