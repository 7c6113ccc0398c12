"""Timers, the console printer and the logger factory."""

from .printer import Printer, get_logger
from .timer import MovingAverage, Timer, TimerFps
