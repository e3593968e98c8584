from nanomod.io.fast5 import (  # noqa: F401
    CorrectedRead,
    read_corrected_events,
    write_corrected_events,
    iter_fast5_files,
)
from nanomod.io.fasta import FastaIndex  # noqa: F401
