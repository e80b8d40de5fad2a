"""Elastic recovery: a host drops mid-stage and is relaunched; the
surviving host keeps waiting at the merge barrier and the final output is
byte-identical to the single-host run (the host-drop twin of
the dryrun's device-drop checkpoint case). Failure detection itself is the
reference's model (Snakemake reruns the failed rule; here the operator
relaunches the failed host) — what the framework guarantees is that
recovery needs ONLY the failed host's work and changes no bytes."""

import os
import subprocess
import sys
import textwrap

import numpy as np

from oracle import mutate, random_dna

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("SCTAG_CHECKPOINT_DIR", None)
    env["SCTAG_SYNC_TIMEOUT"] = "180"
    return env


def test_match_trie_host_drop_and_relaunch(tmp_path):
    rng = np.random.default_rng(23)
    bcs = sorted({random_dna(rng, 16) for _ in range(25)})
    sr = tmp_path / "sr.tsv"
    sr.write_text("".join(f"{b}\t7\n" for b in bcs))
    rows = []
    for i in range(80):
        seg = random_dna(rng, 22)
        if rng.random() < 0.75:
            bc = mutate(rng, bcs[int(rng.integers(len(bcs)))],
                        int(rng.integers(0, 3)))
            seg = seg[:3] + bc + seg[3:6]
        rows.append(f"r{i}\t0\t3\t{seg}\n")
    lr = tmp_path / "lr.tsv"
    lr.write_text("".join(rows))

    single = tmp_path / "single.tsv"
    proc = subprocess.run(
        [sys.executable, "-m", "sctagger", "match_trie", "-lr", str(lr),
         "-sr", str(sr), "-mr", "2", "-t", "1", "-o", str(single)],
        env=_cli_env(), capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]

    multi = tmp_path / "multi.tsv"
    argv = ["match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", "2",
            "-t", "1", "-o", str(multi), "--n-hosts", "2"]

    # host 0: healthy, will block at the part-merge barrier while host 1
    # is down (fs transport, SCTAG_SYNC_TIMEOUT bounds the wait)
    h0 = subprocess.Popen(
        [sys.executable, "-m", "sctagger", *argv, "--host-id", "0"],
        env=_cli_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True,
    )

    # host 1, attempt 1: crashes mid-stage (match_segments raises)
    crash = textwrap.dedent(
        """
        import sys
        import sctagger.stages.match_trie as mt

        def boom(*a, **k):
            raise RuntimeError("injected host crash")

        mt.match_segments = boom
        from sctagger.cli import main
        main(sys.argv[1:])
        """
    )
    h1a = subprocess.run(
        [sys.executable, "-c", crash, *argv, "--host-id", "1"],
        env=_cli_env(), capture_output=True, text=True, timeout=240,
    )
    assert h1a.returncode != 0
    assert "injected host crash" in h1a.stderr
    assert h0.poll() is None, "healthy host must keep waiting, not die"

    # host 1, attempt 2: plain relaunch — recovery needs only this host
    h1b = subprocess.run(
        [sys.executable, "-m", "sctagger", *argv, "--host-id", "1"],
        env=_cli_env(), capture_output=True, text=True, timeout=240,
    )
    assert h1b.returncode == 0, h1b.stderr[-2000:]
    err0 = h0.communicate(timeout=240)[1]
    assert h0.returncode == 0, err0[-2000:]

    assert multi.read_text() == single.read_text()
    assert not list(tmp_path.glob("*.part"))  # merge cleaned up
