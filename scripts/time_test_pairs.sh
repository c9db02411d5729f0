#!/bin/bash
# CPU time of the port's heaviest test files on two trees, in pairs.
#
# Usage: scripts/time_test_pairs.sh <before tree> <after tree> <pairs> <out dir>
#
# Each run times, one file after another with bash's `time` (wall, user
# and sys seconds, children included), `pytest <file> --durations=0` in a
# fresh copy of its tree (no kernel or host library built) with a fresh
# $LURK_TPU_CACHE for each file. The files: the three proving files of
# FILES on both trees, and on the after tree those of AFTER_ONLY too
# (the files the change adds). Odd pairs run the after tree first, even
# pairs the before tree. Logs go to <out dir>/<side>-<pair>/, and a run
# whose logs are all there is not made again (so a cut measurement
# resumes). The last step prints, and writes to <out dir>/summary.json,
# each pair's CPU seconds and margin (what the three files give back
# less what the added files take), each file's medians, and whether the
# payback holds as a gain must: the margin positive in at least 9 of 10
# pairs, and the medians of the totals apart by more than the before
# runs' own spread (the distance between their quartiles).
set -u
before=$(realpath "$1") after=$(realpath "$2") pairs=$3
mkdir -p "$4" && out=$(realpath "$4")
FILES=${FILES-"tests/test_torch_cli.py tests/test_torch_cli_backends.py tests/test_torch_coproc_provers.py"}
AFTER_ONLY=${AFTER_ONLY-"tests/test_torch_circom.py tests/test_torch_wasm.py"}
TIMEFORMAT="WALL %R USER %U SYS %S"

run() {   # <side> <pair> <files...>
    local side=$1 k=$2 src=$before
    shift 2
    [ "$side" = after ] && src=$after
    local d=$out/$side-$k
    if [ ! -d "$d/tree" ] && [ "$(ls "$d"/*.log 2>/dev/null | wc -l)" -ge $# ]; then
        return
    fi
    mkdir -p "$d/tree"
    (cd "$src" && tar --exclude=./lurk_tpu_torch/_build --exclude=__pycache__ \
        --exclude=./.git -cf - .) |
        tar -xf - -C "$d/tree"
    for f in "$@"; do
        local cache
        cache=$(mktemp -d)
        (cd "$d/tree" && { time env LURK_TPU_CACHE="$cache" JAX_PLATFORMS=cpu \
            python -m pytest "$f" -q -p no:cacheprovider -p no:randomly \
            --durations=0; echo "RC $?"; }) > "$d/$(basename "$f" .py).log" 2>&1
        rm -rf "$cache"
    done
    rm -rf "$d/tree"
}

for k in $(seq 1 "$pairs"); do
    if [ $((k % 2)) = 1 ]; then order="after before"; else order="before after"; fi
    for side in $order; do
        if [ "$side" = after ]; then
            # shellcheck disable=SC2086
            run after "$k" $FILES $AFTER_ONLY
        else
            # shellcheck disable=SC2086
            run before "$k" $FILES
        fi
    done
done

python3 - "$out" "$pairs" "$FILES" <<'EOF'
import json, pathlib, re, statistics, sys
out, pairs, files = pathlib.Path(sys.argv[1]), int(sys.argv[2]), sys.argv[3].split()
shared = {pathlib.Path(f).stem for f in files}
med = statistics.median

def times(log):
    text = log.read_text()
    m = re.search(r"WALL ([\d.]+) USER ([\d.]+) SYS ([\d.]+)", text)
    cases = sum(float(s) for s in re.findall(r"^([\d.]+)s (?:call|setup|teardown)",
                                             text, re.M))
    return dict(cases=round(cases, 2), wall=float(m[1]),
                cpu=round(float(m[2]) + float(m[3]), 1), ok="\nRC 0\n" in text)

rows = []
for k in range(1, pairs + 1):
    row = {"pair": k, "first": "after" if k % 2 else "before"}
    for side in ("before", "after"):
        row[side] = {log.stem: times(log)
                     for log in sorted((out / f"{side}-{k}").glob("*.log"))}
    cpu = lambda side, names: sum(t["cpu"] for n, t in row[side].items() if n in names)
    row["before_cpu"] = round(cpu("before", shared), 1)
    row["after_cpu"] = round(cpu("after", shared), 1)
    row["added"] = round(cpu("after", set(row["after"]) - shared), 1)
    row["margin"] = round(row["before_cpu"] - row["after_cpu"] - row["added"], 1)
    row["all_passed"] = all(t["ok"] for s in ("before", "after")
                            for t in row[s].values())
    rows.append(row)
    print(k, row["first"], "first: before", row["before_cpu"], "after",
          row["after_cpu"], "+ added", row["added"], "margin", row["margin"],
          "all passed" if row["all_passed"] else "A FILE FAILED")
files = {side: {name: {key: round(med(r[side][name][key] for r in rows), 2)
                       for key in ("cases", "wall", "cpu")}
                for name in rows[0][side]} for side in ("before", "after")}
for side in ("before", "after"):
    for name, t in files[side].items():
        print(side, name, "median: cases", t["cases"], "s, wall", t["wall"],
              "s, user + sys", t["cpu"], "s")
before = [r["before_cpu"] for r in rows]
after = [round(r["after_cpu"] + r["added"], 1) for r in rows]
q1, _, q3 = statistics.quantiles(before, n=4) if pairs > 1 else (0, 0, 0)
summary = {"before_median": med(before), "after_with_added_median": med(after),
           "before_iqr": round(q3 - q1, 1),
           "wins": sum(r["margin"] > 0 for r in rows), "pairs_run": pairs,
           "all_passed": all(r["all_passed"] for r in rows)}
summary["met"] = (summary["wins"] >= 0.9 * pairs
                  and summary["before_median"] - summary["after_with_added_median"]
                  > summary["before_iqr"])
print(json.dumps(summary))
(out / "summary.json").write_text(json.dumps(
    summary | {"files_median": files, "pairs": rows}, indent=1))
EOF
