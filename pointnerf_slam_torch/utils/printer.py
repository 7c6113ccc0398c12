"""ANSI-coloured console printer and a logger factory (file, TCP, UDP or
stream handler)."""

from __future__ import annotations

import logging
import sys


class Printer:
    """Coloured console event log: one line per call, flushed."""

    RED = "\033[91m"
    GREEN = "\033[92m"
    YELLOW = "\033[93m"
    BLUE = "\033[94m"
    ORANGE = "\033[33m"
    PURPLE = "\033[95m"
    CYAN = "\033[96m"
    BOLD = "\033[1m"
    END = "\033[0m"

    @staticmethod
    def _p(color, *args):
        print(color + " ".join(str(a) for a in args) + Printer.END)
        sys.stdout.flush()

    @staticmethod
    def red(*args):
        Printer._p(Printer.RED, *args)

    @staticmethod
    def green(*args):
        Printer._p(Printer.GREEN, *args)

    @staticmethod
    def yellow(*args):
        Printer._p(Printer.YELLOW, *args)

    @staticmethod
    def orange(*args):
        Printer._p(Printer.ORANGE, *args)

    @staticmethod
    def blue(*args):
        Printer._p(Printer.BLUE, *args)

    @staticmethod
    def bold(*args):
        Printer._p(Printer.BOLD, *args)


def get_logger(name: str, file: str | None = None, level=logging.INFO,
               tcp: tuple | None = None, udp: tuple | None = None):
    """A logger named `name` with one handler: a file, a TCP or UDP
    socket, or the console."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if file:
        h = logging.FileHandler(file)
    elif tcp:
        from logging.handlers import SocketHandler
        h = SocketHandler(*tcp)
    elif udp:
        from logging.handlers import DatagramHandler
        h = DatagramHandler(*udp)
    else:
        h = logging.StreamHandler()
    h.setFormatter(fmt)
    logger.addHandler(h)
    return logger
