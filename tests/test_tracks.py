"""Vortex-track association (diagnostics/tracks.py) — the completion of
the reference's find_min -> pres_timeseries.txt workflow
(/root/reference/test/02-test_invert_pressure/example.sh:16)."""

import numpy as np
import pytest

from xlab_fftbarotropic.diagnostics.tracks import (
    Track, build_tracks, cluster_minima, format_tracks, periodic_delta)


def test_periodic_delta_wraps():
    assert periodic_delta(1, 62, 64) == 3          # across the seam
    assert periodic_delta(62, 1, 64) == -3
    assert periodic_delta(10, 4, 64) == 6
    np.testing.assert_array_equal(
        periodic_delta(np.array([0, 63]), np.array([63, 0]), 64),
        [1, -1])


def test_cluster_minima_one_well_per_vortex():
    # 5 points in one well + 3 in another, interleaved depths
    x = [10, 11, 10, 9, 12, 40, 41, 40]
    y = [10, 10, 11, 10, 12, 40, 41, 39]
    v = [-9.0, -8.5, -8.0, -7.5, -7.0, -5.0, -4.5, -4.0]
    cores = cluster_minima(x, y, v, 64, 64, radius=8.0)
    assert cores == [(10, 10, -9.0), (40, 40, -5.0)]


def test_cluster_minima_periodic_well():
    # a well straddling the domain seam is ONE core
    cores = cluster_minima([1, 63], [0, 0], [-2.0, -1.5], 64, 64,
                           radius=4.0)
    assert cores == [(1, 0, -2.0)]


def _rec(step, pts):
    xs, ys, vs = zip(*pts)
    return (step, np.array(xs), np.array(ys), np.array(vs))


def test_build_tracks_two_vortices_with_wrap():
    # vortex A drifts +3 in x per step across the seam; B sits still
    recs = [
        _rec(0, [(60, 8, -9.0), (30, 30, -4.0)]),
        _rec(10, [(63, 8, -9.1), (30, 31, -4.1)]),
        _rec(20, [(2, 8, -9.2), (31, 30, -4.2)]),   # A wrapped
    ]
    tracks = build_tracks(recs, 64, 64, cluster_radius=4.0, max_jump=8.0)
    assert len(tracks) == 2
    a = next(t for t in tracks if t.x[0] == 60)
    b = next(t for t in tracks if t.x[0] == 30)
    assert a.x == [60, 63, 2] and a.steps == [0, 10, 20]
    assert b.steps == [0, 10, 20]
    assert a.value == [-9.0, -9.1, -9.2]


def test_build_tracks_birth_and_jump_cut():
    recs = [
        _rec(0, [(10, 10, -5.0)]),
        # far beyond max_jump: old track dies, a new one is born
        _rec(10, [(40, 40, -5.0)]),
        _rec(20, [(41, 40, -5.1), (10, 10, -3.0)]),  # and a second birth
    ]
    tracks = build_tracks(recs, 128, 128, cluster_radius=4.0, max_jump=8.0)
    assert len(tracks) == 3
    assert tracks[0].steps == [0]
    assert tracks[1].steps == [10, 20] and tracks[1].x == [40, 41]
    assert tracks[2].steps == [20]


def test_greedy_matching_is_globally_nearest():
    # two heads, two cores; pairwise-nearest assignment must win even
    # though head order would greedily grab the wrong core first
    recs = [
        _rec(0, [(10, 10, -9.0), (14, 10, -8.0)]),
        _rec(1, [(15, 10, -8.1), (9, 10, -9.1)]),
    ]
    tracks = build_tracks(recs, 64, 64, cluster_radius=2.0, max_jump=8.0)
    assert len(tracks) == 2
    deep = next(t for t in tracks if t.value[0] == -9.0)
    assert deep.x == [10, 9]


def test_format_tracks_contract():
    t = Track(0, [0, 10], [1, 2], [3, 4], [-1.0, -2.0])
    s = format_tracks([t])
    assert s.splitlines() == ["0 0 1 3 -1.00000e+00",
                              "0 10 2 4 -2.00000e+00"]


def test_cli_tracks_end_to_end(tmp_path, capsys, monkeypatch):
    from xlab_fftbarotropic.cli import find_min as cli
    from xlab_fftbarotropic.io.fieldio import write_field

    nx = ny = 32
    files = []
    for k, step in enumerate((0, 5, 10)):
        f = np.zeros((nx, ny), np.float32)
        f[4 + k, 7] = -10.0          # drifting minimum
        f[20, 20] = -3.0             # stationary second vortex
        path = tmp_path / f"pres_step_{step}.bin"
        write_field(path, f)
        files.append(str(path))
    import io
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(files) + "\n"))
    out = tmp_path / "tracks.txt"
    rc = cli.main(["--nx", str(nx), "--ny", str(ny), "--cpu",
                   "-n", "2", "--tracks", str(out),
                   "--cluster-radius", "3", "--max-jump", "6"])
    assert rc == 0
    rows = [ln.split() for ln in out.read_text().splitlines()]
    # two tracks x three steps
    assert len(rows) == 6
    assert len({r[0] for r in rows}) == 2
    drift = [r for r in rows if int(r[2]) in (4, 5, 6)]
    assert [int(r[1]) for r in drift] == [0, 5, 10]
    assert [int(r[2]) for r in drift] == [4, 5, 6]


def test_cli_tracks_mixed_step_names_error(tmp_path, capsys, monkeypatch):
    """--tracks refuses a mix of parsed '_step_N' names and unparsable
    ones: positional fallback indices could collide with or interleave
    the real step numbers and silently corrupt track ordering (round-3
    ADVICE). All-unparsable input still works (stdin order = time axis)."""
    import io

    from xlab_fftbarotropic.cli import find_min as cli
    from xlab_fftbarotropic.io.fieldio import write_field

    nx = ny = 16
    f = np.zeros((nx, ny), np.float32)
    f[3, 3] = -5.0
    good = tmp_path / "pres_step_0.bin"
    bad = tmp_path / "pres_final.bin"
    for p in (good, bad):
        write_field(p, f)

    out = tmp_path / "tracks.txt"
    monkeypatch.setattr("sys.stdin",
                        io.StringIO(f"{good}\n{bad}\n"))
    rc = cli.main(["--nx", str(nx), "--ny", str(ny), "--cpu",
                   "-n", "1", "--tracks", str(out)])
    assert rc == 2
    assert not out.exists()
    assert "did not parse" in capsys.readouterr().err

    # all-unparsable: accepted, stdin order defines steps 0..K-1
    bad2 = tmp_path / "pres_later.bin"
    f2 = np.zeros((nx, ny), np.float32)
    f2[4, 3] = -5.0
    write_field(bad2, f2)
    monkeypatch.setattr("sys.stdin",
                        io.StringIO(f"{bad}\n{bad2}\n"))
    rc = cli.main(["--nx", str(nx), "--ny", str(ny), "--cpu",
                   "-n", "1", "--tracks", str(out), "--max-jump", "4"])
    assert rc == 0
    rows = [ln.split() for ln in out.read_text().splitlines()]
    assert [int(r[1]) for r in rows] == [0, 1]


def test_hungarian_matches_bruteforce():
    """_hungarian against brute-force minimum over all permutations for
    random small cost matrices."""
    import itertools

    from xlab_fftbarotropic.diagnostics.tracks import _hungarian

    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 4, 5, 6):
        for _ in range(20):
            c = rng.uniform(0, 10, (n, n))
            assign = _hungarian(c)
            assert sorted(assign) == list(range(n))
            got = sum(c[i, assign[i]] for i in range(n))
            best = min(sum(c[i, p[i]] for i in range(n))
                       for p in itertools.permutations(range(n)))
            assert abs(got - best) < 1e-9, (n, got, best)


def test_crowded_matching_keeps_both_tracks():
    """A case the greedy sorted-distance matcher gets wrong: heads at
    x=0 and x=6, new cores at x=5 and x=8 with max_jump=5. Greedy pairs
    (6->5) first and strands (0->8) out of range, killing one track and
    birthing a spurious one; the optimal assignment keeps both alive
    via (0->5, 6->8)."""
    from xlab_fftbarotropic.diagnostics.tracks import build_tracks

    nx = ny = 64
    records = [
        (0, [0, 6], [0, 0], [-10.0, -9.0]),
        (1, [5, 8], [0, 0], [-10.0, -9.0]),
    ]
    tracks = build_tracks(records, nx, ny, cluster_radius=1.0,
                          max_jump=5.0)
    assert len(tracks) == 2
    assert all(len(t.steps) == 2 for t in tracks)
    by_start = {t.x[0]: t for t in tracks}
    assert by_start[0].x == [0, 5]
    assert by_start[6].x == [6, 8]
