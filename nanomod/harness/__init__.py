from nanomod.harness.simulate import (  # noqa: F401
    run_simulate,
    run_simulat2,
    run_downsampling,
    mix_and_rank,
    load_group_reads,
)
