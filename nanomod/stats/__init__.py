from nanomod.stats.battery import run_battery, TestResult  # noqa: F401
from nanomod.stats.combine import combine_neighbor_pvalues  # noqa: F401
