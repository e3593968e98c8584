from nanomod.signal.events import extract_events, EventTable  # noqa: F401
from nanomod.signal.normalize import (  # noqa: F401
    load_kmer_model,
    kmer_shift_scale,
    mad_normalize,
)
