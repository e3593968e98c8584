from nanomod.rank.ranking import (  # noqa: F401
    SignTable,
    sort_sites,
    top_sites,
    region_rank,
)
