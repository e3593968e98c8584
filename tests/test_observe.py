"""Observability (per-stage counters, metrics JSON) and Annotate --resume."""

import json
import os

import numpy as np

from fixtures import make_genome, make_corrected_dataset, make_raw_dataset
from nanomod.utils.observe import Observer, observer, stage
from nanomod.config import OUTPUT_INFO, OUTPUT_WARNING


def test_observer_stage_accumulates():
    obs = Observer()
    with obs.stage("ingest", unit="reads") as s:
        s.add(10)
    with obs.stage("ingest", unit="reads") as s:
        s.add(5)
    snap = obs.snapshot()
    assert snap["ingest"]["items"] == 15
    assert snap["ingest"]["calls"] == 2
    assert snap["ingest"]["seconds"] >= 0


def test_observer_report_gated(capsys):
    obs = Observer()
    with obs.stage("x"):
        pass
    assert obs.report(OUTPUT_WARNING) is None          # gated off
    assert capsys.readouterr().out == ""
    text = obs.report(OUTPUT_INFO)
    assert "stage timings" in text


def test_observer_to_json(tmp_path):
    obs = Observer()
    obs.add("battery", items=1000, seconds=0.5, unit="positions")
    path = obs.to_json(str(tmp_path / "m.json"))
    payload = json.load(open(path))
    assert payload["stages"]["battery"]["items"] == 1000
    assert payload["stages"]["battery"]["per_sec"] == 2000.0


def test_detect_writes_metrics_file(tmp_path):
    from nanomod.config import DetectConfig
    from nanomod.detect import run_detect

    chrom, genome = make_genome(length=160, seed=3)
    ctrl = str(tmp_path / "ctrl")
    case = str(tmp_path / "case")
    make_corrected_dataset(ctrl, chrom, genome, n_reads=12, seed=1)
    make_corrected_dataset(case, chrom, genome, n_reads=12, seed=2,
                           mod_pos=80, mod_delta=1.4)
    mfile = str(tmp_path / "metrics.json")
    cfg = DetectConfig(wrk_base1=ctrl, wrk_base2=case,
                       out_folder=str(tmp_path / "out"),
                       min_lr=0, metrics_file=mfile)
    observer().reset()
    run_detect(cfg)
    payload = json.load(open(mfile))
    for name in ("ingest", "accumulate", "test_battery",
                 "combine_pvalues", "rank"):
        assert name in payload["stages"], name
    assert payload["stages"]["ingest"]["items"] == 24


def test_annotate_resume_skips_done(tmp_path, capsys):
    from nanomod.config import AnnotateConfig, replace
    from nanomod.resquiggle import annotate_folder
    from nanomod.io.fast5 import has_corrected_group

    chrom, genome = make_genome(length=260, seed=9)
    fasta = str(tmp_path / "ref.fa")
    with open(fasta, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    reads = str(tmp_path / "reads")
    paths = make_raw_dataset(reads, chrom, genome, n_reads=4, seed=4,
                             error_rate=0.0)
    cfg = AnnotateConfig(wrk_base1=reads, ref_fasta=fasta, resume=True)
    n1, _ = annotate_folder(cfg)
    assert n1 >= 3
    done = [p for p in paths if has_corrected_group(p)]
    assert len(done) == n1
    # second run with resume skips everything already annotated
    capsys.readouterr()
    n2, _ = annotate_folder(cfg)
    out = capsys.readouterr().out
    assert f"Resume: {n1} already annotated" in out
    assert n2 <= len(paths) - n1
