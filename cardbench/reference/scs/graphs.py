"""Eager stand-ins for the port's ``utils/graphs.py`` helpers that the frozen
SCS engine calls: the reference never captures a graph, so a loop reads its
condition on the host before each trip and an overflow raises at once."""

from __future__ import annotations


def run_while(cond, body, max_trips: int) -> bool:
    """Run ``body`` while ``cond()`` holds, at most ``max_trips`` times ->
    whether the loop may have stopped at its bound."""
    if max_trips < 1:
        return True
    for _ in range(max_trips):
        if not bool(cond()):
            return False
        body()
    return True


def overflowed(cond, what: str) -> None:
    if bool(cond):
        raise OverflowError(f"reference: {what} ran past its bound")
