"""chip_smoke.py's phase times for two trees of the repo on one card, run
in turns (A, B, B, A), so that a drift of the host between runs shows in
each tree's pair and not as a difference between the trees.

    python3 scripts/smoke_pairs.py build/parent build/change

Each run is ``python3 chip_smoke.py`` from that tree's root with nothing
built (the tree's ``gan_sr_wind_field_tpu_torch/_build`` is removed
first, as a fresh checkout has none), under the smoke's own 1200 s limit;
its output goes to ``chiprun_out/smoke_pairs_<tree>_<turn>.log`` of this
repo. The script prints the card's name and power limit, each run's exit
code, and for each phase the seconds of every run: from the smoke's
``phase N starts at S s`` and ``total T s`` lines (phase 1 from 0, the
last to the total), and the smoke's own ``phase N took T s`` lines where
it prints them. It exits 1 if a run failed. It needs the card."""
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 1200


def phases(text):
    """{phase: seconds from its start to the next's} and {phase: the
    smoke's own 'took' seconds} from one run's output."""
    starts = {1: 0.0}
    for n, s in re.findall(r"^phase (\d+) starts at ([\d.]+) s", text, re.M):
        starts[int(n)] = float(s)
    total = re.findall(r"^total ([\d.]+) s", text, re.M)
    ends = sorted(starts)
    span = {}
    for a, b in zip(ends, ends[1:] + [None]):
        end = starts[b] if b is not None else (
            float(total[-1]) if total else None)
        span[a] = None if end is None else end - starts[a]
    if total:
        span["total"] = float(total[-1])
    took = {int(n): float(s) for n, s in re.findall(
        r"^\s*phase (\d+) took ([\d.]+) s", text, re.M)}
    return span, took


def run(tree, label, turn, out_dir):
    """One smoke run from ``tree``'s root with nothing built. → (exit
    code, its output, wall seconds)."""
    shutil.rmtree(os.path.join(tree, "gan_sr_wind_field_tpu_torch",
                               "_build"), ignore_errors=True)
    t = time.monotonic()
    try:
        p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                           capture_output=True, text=True, timeout=LIMIT_S,
                           start_new_session=True)
        code, text = p.returncode, p.stdout + p.stderr
    except subprocess.TimeoutExpired as e:
        code = 124
        text = (e.stdout or b"").decode() + (e.stderr or b"").decode()
    wall = time.monotonic() - t
    with open(os.path.join(out_dir, f"smoke_pairs_{label}_{turn}.log"),
              "w") as f:
        f.write(text)
    return code, text, wall


def main():
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    trees = [os.path.abspath(a) for a in sys.argv[1:]]
    labels = [os.path.basename(t.rstrip("/")) for t in trees]
    if labels[0] == labels[1]:
        labels = ["A", "B"]
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    order = [0, 1, 1, 0]
    runs, seen, failed = [], [0, 0], False
    for i in order:
        seen[i] += 1
        code, text, wall = run(trees[i], labels[i], seen[i], out_dir)
        span, took = phases(text)
        runs.append((f"{labels[i]}{seen[i]}", span, took))
        failed |= code != 0
        print(f"{labels[i]} run {seen[i]}: exit {code}, {wall:.1f} s wall",
              flush=True)
    keys = sorted({k for _, s, _ in runs for k in s if k != "total"})
    print("phase  " + "  ".join(f"{n:>16}" for n, _, _ in runs))
    for k in keys + ["total"]:
        cells = []
        for _, span, took in runs:
            v = span.get(k)
            cell = "-" if v is None else f"{v:.1f}"
            if k in took:
                cell += f" ({took[k]:.1f})"
            cells.append(f"{cell:>16}")
        print(f"{k!s:>5}  " + "  ".join(cells))
    print("(seconds from a phase's start to the next's; in brackets the "
          f"smoke's own 'phase N took' line; {card})")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
