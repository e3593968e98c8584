"""CLI smoke tests: subcommands drive the pipelines end to end."""

import os

import pytest

from fixtures import make_genome, make_corrected_dataset, make_raw_dataset
from nanomod.cli import main, build_parser


def test_parser_mirrors_reference_args():
    p = build_parser()
    a = p.parse_args([
        "detect", "--wrkBase1", "x", "--wrkBase2", "y", "--Pos", "spel:3073",
        "--testMethod", "stouffer", "--coverages", "40-40",
    ])
    assert a.Pos == "spel:3073"
    assert a.coverages == "40-40"
    a = p.parse_args(["Annotate", "--wrkBase1", "x", "--Ref", "r.fa"])
    assert a.Resegment_signal_wind == 4


def test_cli_detect_end_to_end(tmp_path, capsys):
    chrom, genome = make_genome(length=240, seed=5)
    ctrl = str(tmp_path / "ctrl")
    case = str(tmp_path / "case")
    make_corrected_dataset(ctrl, chrom, genome, n_reads=16, seed=1)
    make_corrected_dataset(case, chrom, genome, n_reads=16, seed=2,
                           mod_pos=100, mod_delta=1.4)
    out = str(tmp_path / "out")
    main(["detect", "--wrkBase1", ctrl, "--wrkBase2", case,
          "--outFolder", out, "--min_lr", "0", "--window", "7"])
    text = capsys.readouterr().out
    assert "Rank 1:" in text
    assert f"{chrom}" in text.split("Rank 1:")[1].split("\n")[0]
    assert " 101 " in text.split("Rank 1:")[1].split("\n")[0]  # 1-based
    assert os.path.exists(os.path.join(out, "mod_sign_test.txt"))
    assert os.path.exists(os.path.join(out, "rplot_mod.pdf"))


def test_cli_annotate_end_to_end(tmp_path):
    chrom, genome = make_genome(length=300, seed=6)
    fasta = str(tmp_path / "ref.fa")
    with open(fasta, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    reads = str(tmp_path / "reads")
    make_raw_dataset(reads, chrom, genome, n_reads=4, seed=7, error_rate=0.02)
    main(["Annotate", "--wrkBase1", reads, "--Ref", fasta])
    from nanomod.io.fast5 import read_corrected_events
    ok = sum(read_corrected_events(os.path.join(reads, f)) is not None
             for f in sorted(os.listdir(reads)))
    assert ok >= 3
