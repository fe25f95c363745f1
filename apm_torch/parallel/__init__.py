"""Distribution strategies and the execution planner."""

from .plan import Plan, choose_block_windows, choose_strategy, get_ratio
from .strategies import (
    count_database_over_devices,
    count_distributed,
    count_patterns_over_devices,
)

__all__ = [
    "Plan",
    "choose_block_windows",
    "choose_strategy",
    "get_ratio",
    "count_distributed",
    "count_database_over_devices",
    "count_patterns_over_devices",
]
