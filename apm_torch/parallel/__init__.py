"""Execution planner (single device so far; see ROADMAP.md)."""

from .plan import Plan, choose_block_windows, choose_strategy, get_ratio

__all__ = ["Plan", "choose_block_windows", "choose_strategy", "get_ratio"]
