"""The console printer and the logger factory (`printer`), the program's
tracer (`tracing`) and the device resolver (`device`)."""

from .printer import Printer, get_logger
