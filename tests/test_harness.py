"""Simulation harness tests: mixing trials must rank the planted site
highly at high mix percentages and poorly at zero signal."""

import os

import numpy as np
import pytest

from fixtures import make_genome, make_corrected_dataset
from nanomod.config import SimulateConfig, RankConfig, replace
from nanomod.harness.simulate import (group_ranks, load_group_reads,
                                          rank_bins, run_downsampling,
                                          run_simulat2, run_simulate)

MOD_POS = 120


@pytest.fixture(scope="module")
def sim_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sim"))
    chrom, genome = make_genome(length=260, seed=21)
    case = os.path.join(root, "case")
    ctrl = os.path.join(root, "ctrl")
    make_corrected_dataset(case, chrom, genome, n_reads=40, seed=31,
                           mod_pos=MOD_POS, mod_delta=1.4, strands="-")
    make_corrected_dataset(ctrl, chrom, genome, n_reads=80, seed=32,
                           strands="-")
    case_reads = load_group_reads(case)
    ctrl_reads = load_group_reads(ctrl)
    return root, chrom, case, ctrl, case_reads, ctrl_reads


def _cfg(root, chrom, case, ctrl, **kw):
    cfg = SimulateConfig(
        wrk_base1=ctrl, wrk_base2=case,
        out_folder=os.path.join(root, "out"),
        target_chr=chrom, target_pos=MOD_POS, target_strand="-",
        random_times=3, rank=RankConfig(window=2),
    )
    return replace(cfg, **kw) if kw else cfg


def test_simulate_high_percentage_ranks_first(sim_data):
    root, chrom, case, ctrl, case_reads, ctrl_reads = sim_data
    n = len(ctrl_reads)
    mix = dict(list(ctrl_reads.items())[: n // 2])
    test_grp = dict(list(ctrl_reads.items())[n // 2:])
    cfg = _cfg(root, chrom, case, ctrl, percentages=(0.9,))
    res = run_simulate(cfg, case_reads=case_reads, control_mix=mix,
                       control_test=test_grp)
    assert all(r == 1 for r in res[0.9]), res
    # .output + .done files written
    assert os.path.exists(os.path.join(root, "out", "mod.output"))
    assert os.path.exists(os.path.join(root, "out", "mod.done"))


def test_simulate_zero_signal_rarely_ranks(sim_data):
    root, chrom, case, ctrl, case_reads, ctrl_reads = sim_data
    n = len(ctrl_reads)
    mix = dict(list(ctrl_reads.items())[: n // 2])
    test_grp = dict(list(ctrl_reads.items())[n // 2:])
    # control vs control: target should not be rank 1 consistently
    cfg = _cfg(root, chrom, case, ctrl, percentages=(0.9,), file_id="null")
    res = run_simulate(cfg, case_reads=mix, control_mix=mix,
                       control_test=test_grp)
    assert not all(r == 1 for r in res[0.9])


@pytest.fixture(scope="module")
def grid_data(tmp_path_factory):
    """Numbered-subfolder layout for cluster/grid mode: ctrl/{0,1,2},
    case/{0,1} (the reference's getSubFolders discovery,
    ref mySimulate.py:74-99)."""
    root = str(tmp_path_factory.mktemp("grid"))
    chrom, genome = make_genome(length=260, seed=21)
    ctrl = os.path.join(root, "ctrl")
    case = os.path.join(root, "case")
    for i, seed in enumerate((41, 42, 43)):
        make_corrected_dataset(os.path.join(ctrl, str(i)), chrom, genome,
                               n_reads=16, seed=seed, strands="-")
    for j, seed in enumerate((51, 52)):
        make_corrected_dataset(os.path.join(case, str(j)), chrom, genome,
                               n_reads=16, seed=seed,
                               mod_pos=MOD_POS, mod_delta=1.4, strands="-")
    return root, chrom, ctrl, case


def _grid_cfg(root, chrom, ctrl, case, out, **kw):
    cfg = SimulateConfig(
        wrk_base1=ctrl, wrk_base2=case,
        out_folder=os.path.join(root, out),
        target_chr=chrom, target_pos=MOD_POS, target_strand="-",
        percentages=(0.9,), random_times=2, foldersep=1,
        rank=RankConfig(window=2),
    )
    return replace(cfg, **kw) if kw else cfg


def test_simulate_grid_single_process(grid_data):
    """The (mi, mj, mk) grid covers range(max_int) pairs with
    mk = (mi + foldersep) %% max0, reference job naming, and the merge
    groups ranks by percentage."""
    from nanomod.harness.simulate import (merge_grid_outputs,
                                              run_simulate_grid)
    root, chrom, ctrl, case = grid_data
    cfg = _grid_cfg(root, chrom, ctrl, case, "out_grid")
    fids, local = run_simulate_grid(cfg)
    # max ints are 2 (ctrl: 0,1,2) and 1 (case: 0,1) -> exclusive bounds,
    # reproducing the reference's range(subf_max_int) quirk
    assert fids == ["mod_0_0_1_0.90000", "mod_1_0_0_0.90000"]
    assert set(local) == set(fids)
    for fid in fids:
        assert os.path.isfile(os.path.join(cfg.out_folder, fid + ".output"))
        assert os.path.isfile(os.path.join(cfg.out_folder, fid + ".done"))
    grouped, labels = merge_grid_outputs(cfg, fids)
    assert 0.9 in grouped
    # 90% case mix: the planted site dominates
    assert grouped[0.9][labels[0]] > 0.5


def test_simulate_grid_two_processes(grid_data):
    """Real multi-process run: two OS processes each execute their
    round-robin shard of the grid (shared-nothing, like the reference's
    qsub workers); the file-level merge must equal the single-process
    result."""
    import subprocess
    import sys

    from nanomod.harness.simulate import merge_grid_outputs

    root, chrom, ctrl, case = grid_data
    cfg = _grid_cfg(root, chrom, ctrl, case, "out_grid2")

    driver = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "from nanomod.config import SimulateConfig, RankConfig\n"
        "from nanomod.harness.simulate import run_simulate_grid\n"
        "cfg = SimulateConfig(wrk_base1=%r, wrk_base2=%r, out_folder=%r,\n"
        "    target_chr=%r, target_pos=%d, target_strand='-',\n"
        "    percentages=(0.9,), random_times=2, foldersep=1,\n"
        "    rank=RankConfig(window=2))\n"
        "run_simulate_grid(cfg, process_id=int(sys.argv[1]), "
        "process_count=2)\n"
    ) % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         ctrl, case, cfg.out_folder, chrom, MOD_POS)

    procs = [subprocess.Popen([sys.executable, "-c", driver, str(pid)])
             for pid in range(2)]
    for p in procs:
        assert p.wait(timeout=500) == 0

    fids = ["mod_0_0_1_0.90000", "mod_1_0_0_0.90000"]
    grouped, labels = merge_grid_outputs(cfg, fids)
    # same dataset + seeds as the single-process grid -> same merged bins
    from nanomod.harness.simulate import run_simulate_grid
    cfg1 = _grid_cfg(root, chrom, ctrl, case, "out_grid")
    if not os.path.isdir(cfg1.out_folder):      # test-order independence
        run_simulate_grid(cfg1)
    grouped1, _ = merge_grid_outputs(cfg1, fids)
    assert grouped == grouped1


def test_simulat2_sweep_sharded(sim_data):
    """CaseSize ladder shards round-robin across processes; the runType-3
    merge over per-size .output files recovers the full sweep."""
    from nanomod.harness.simulate import (run_simulat2_sweep,
                                              summarize_outputs)
    root, chrom, case, ctrl, case_reads, ctrl_reads = sim_data
    cfg = _cfg(root, chrom, case, ctrl, percentage=0.9, random_times=1,
               file_id="s2shard",
               **{"out_folder": os.path.join(root, "out_s2")})
    sizes = [8, 12, 16]
    r0 = run_simulat2_sweep(cfg, case_sizes=sizes, process_id=0,
                            process_count=2)
    r1 = run_simulat2_sweep(cfg, case_sizes=sizes, process_id=1,
                            process_count=2)
    assert sorted(list(r0) + list(r1)) == sizes
    fids = [f"s2shard_{cs}" for cs in sizes]
    grouped, labels = summarize_outputs(cfg.out_folder, fids)
    assert len(grouped) >= 1


def test_simulat2_exact_sampling(sim_data):
    root, chrom, case, ctrl, case_reads, ctrl_reads = sim_data
    cfg = _cfg(root, chrom, case, ctrl, percentage=0.5, case_size=20,
               random_times=3, file_id="s2")
    ranks = run_simulat2(cfg, case_reads=case_reads, control_reads=ctrl_reads)
    assert len(ranks) == 3
    assert all(r == 1 for r in ranks), ranks


def test_downsampling_coverage_check(sim_data):
    root, chrom, case, ctrl, case_reads, ctrl_reads = sim_data
    cfg = _cfg(root, chrom, case, ctrl, case_size=60, random_times=2,
               file_id="ds")
    ranks = run_downsampling(cfg, case_reads=case_reads,
                             control_reads=ctrl_reads)
    # case vs control directly: planted site must dominate
    assert len(ranks) == 2 and all(r == 1 for r in ranks), ranks


def test_rank_bins_cover_all_ranks():
    bins, split_points, labels = rank_bins(2061)
    assert bins[1] == labels[0]
    assert bins[split_points[-1]] == labels[-2]
    grouped, labs = group_ranks({0.3: [1, 1, 2, 50, -1]}, seqsize=2061)
    assert abs(sum(grouped[0.3].values()) - 1.0) < 1e-9


def test_plots_render(sim_data, tmp_path):
    root, chrom, case, ctrl, case_reads, ctrl_reads = sim_data
    from nanomod.harness.plots import plot_rank_histogram
    grouped, labels = group_ranks({0.3: [1, 2, 3], 0.5: [1, 1, 1]})
    p = plot_rank_histogram(grouped, labels, str(tmp_path / "hist.png"))
    assert os.path.getsize(p) > 1000


def test_plot_rank_histogram_grid(tmp_path):
    from nanomod.harness.plots import plot_rank_histogram_grid
    grouped, labels = group_ranks({0.3: [1, 2, 3], 0.5: [1, 1, 1]})
    panels = {f"mod{i}" for i in range(9)}
    panels = {name: (grouped, labels) for name in sorted(panels)}
    p = plot_rank_histogram_grid(panels, str(tmp_path / "grid.png"))
    assert os.path.getsize(p) > 1000
    # TIFF export (Hist_sim_plot9tif.R equivalent)
    t = plot_rank_histogram_grid(panels, str(tmp_path / "grid.tif"),
                                 fmt="tiff", dpi=150)
    with open(t, "rb") as f:
        magic = f.read(4)
    assert magic in (b"II*\x00", b"MM\x00*")   # little/big-endian TIFF


def test_plot_top_sites_density_and_violin(tmp_path):
    """Both plotType modes of the per-site window plot render
    (ref Base_Most_Significant_Plot.R violin :5-85 / density :86-188)."""
    import numpy as np
    from fixtures import make_genome, make_corrected_dataset
    from nanomod.config import DetectConfig, replace
    from nanomod.detect import ingest_group, detect_from_pools
    from nanomod.harness.plots import plot_top_sites
    from nanomod.rank.ranking import top_sites

    chrom, genome = make_genome(length=120, seed=21)
    ctrl = str(tmp_path / "c1")
    case = str(tmp_path / "c2")
    make_corrected_dataset(ctrl, chrom, genome, n_reads=10, seed=1)
    make_corrected_dataset(case, chrom, genome, n_reads=10, seed=2,
                           mod_pos=60, mod_delta=1.5)
    cfg = DetectConfig(wrk_base1=ctrl, wrk_base2=case,
                       out_folder=str(tmp_path / "out"), min_lr=0)
    pools1 = ingest_group(ctrl, cfg)
    pools2 = ingest_group(case, cfg)
    table, order = detect_from_pools(pools1, pools2, cfg)
    sites = top_sites(table, order, cfg.stats, cfg.rank, top_n=2)
    for ptype in ("Density", "Violin"):
        c = replace(cfg, plot_type=ptype,
                    out_folder=str(tmp_path / f"out_{ptype}"))
        p = plot_top_sites(table, sites, pools1, pools2, c, max_sites=2)
        assert os.path.getsize(p) > 2000, ptype


def test_flat_reads_pools_match_per_read_rebuild(sim_data):
    """The flattened trial path (FlatReads + pools_from_selections) must
    produce BYTE-identical pools to the per-read PoolBuilder rebuild for
    the same read selection (VERDICT r4: the harness's per-trial per-read
    rebuild was the last interpreted hot loop)."""
    import random

    from nanomod.harness.simulate import (FlatReads, _pools_from_reads,
                                              pools_from_selections)

    root, chrom, case_dir, control_dir, reads, other = sim_data
    flat = FlatReads(reads)
    oflat = FlatReads(other)

    # full-group pools
    a = pools_from_selections([flat.select_all()])
    b = _pools_from_reads([reads])
    assert set(a) == set(b)
    for g in a:
        np.testing.assert_array_equal(a[g].positions, b[g].positions)
        np.testing.assert_array_equal(a[g].counts, b[g].counts)
        np.testing.assert_array_equal(a[g].values, b[g].values)
        np.testing.assert_array_equal(a[g].base, b[g].base)

    # Bernoulli-selected multi-set pools, same RNG stream as mix_and_rank
    rng = random.Random(7)
    keys = flat.keys
    keep = np.fromiter((rng.uniform(0, 1) <= 0.6 for _ in keys), bool,
                       count=len(keys))
    okeep = np.fromiter((rng.uniform(0, 1) < 0.4 for _ in oflat.keys), bool,
                        count=oflat.n_reads)
    sub = {k: reads[k] for k, kp in zip(keys, keep) if kp}
    osub = {k: other[k] for k, kp in zip(oflat.keys, okeep) if kp}
    a = pools_from_selections([flat.select(keep), oflat.select(okeep)])
    b = _pools_from_reads([sub, osub])
    assert set(a) == set(b)
    for g in a:
        np.testing.assert_array_equal(a[g].positions, b[g].positions)
        np.testing.assert_array_equal(a[g].counts, b[g].counts)
        np.testing.assert_array_equal(a[g].values, b[g].values)
        np.testing.assert_array_equal(a[g].base, b[g].base)


def test_flat_reads_wide_span_raw_fallback():
    """Position spans beyond the 29-bit key budget fall back to raw
    (pos, val, cod) selection entries; pools must still match the
    per-read rebuild."""
    import types

    from nanomod.harness.simulate import (FlatReads, _pools_from_reads,
                                              pools_from_selections)

    def mk(start, seed):
        rng = np.random.default_rng(seed)
        L = 50
        return types.SimpleNamespace(
            chrom="big", strand="+", start=start,
            norm_mean=np.round(rng.normal(0, 1, L), 3).astype(np.float32),
            base=np.frombuffer(b"A" * L, dtype="S1").copy())

    reads = {f"r{i}": mk(start, i)
             for i, start in enumerate([0, 10_000, (1 << 29) + 5000,
                                        (1 << 30)])}
    flat = FlatReads(reads)
    assert any(e[0] == "raw" for e in flat.groups.values())
    a = pools_from_selections([flat.select_all()])
    b = _pools_from_reads([reads])
    for g in b:
        np.testing.assert_array_equal(a[g].positions, b[g].positions)
        np.testing.assert_array_equal(a[g].values, b[g].values)
        np.testing.assert_array_equal(a[g].counts, b[g].counts)


def test_canonical_key_codec_roundtrip():
    from nanomod.accum.pools import (build_canonical_keys,
                                         decode_canonical_keys,
                                         pack_observations,
                                         pack_sorted_keys)

    rng = np.random.default_rng(4)
    n = 5000
    pos = rng.integers(100, 90_000, n).astype(np.int64)
    val = np.round(rng.normal(0, 1, n), 3).astype(np.float32)
    cod = rng.integers(0, 5, n).astype(np.int8)
    key, pmin = build_canonical_keys(pos, val, cod)
    p2, v2, c2 = decode_canonical_keys(key, pmin)
    np.testing.assert_array_equal(p2, pos)
    np.testing.assert_array_equal(v2, val)
    np.testing.assert_array_equal(c2, cod)
    # sorted keys decode into the same pools as the full pack
    key.sort()
    a = pack_sorted_keys("c", "+", key, pmin)
    b = pack_observations("c", "+", pos, val, cod)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.base, b.base)
