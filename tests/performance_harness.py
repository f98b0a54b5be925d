"""Performance harness: build + interpolate timings across refinement
levels and methods, with peak-RSS tracking.

Rebuild of the reference harness (tests/performance_test.py:52-262):
timings run in-process; peak RSS follows the REFERENCE methodology — a
fresh subprocess per (family, level, method) whose high-water mark is
read from /proc/self/status VmHWM (the reference polls psutil at 100 ms,
performance_test.py:52-79; VmHWM is the kernel's exact version of the
same number).  This keeps the parent's JAX runtime and compile caches
out of the comparison.  One process per device: every RSS child runs
BEFORE the parent touches the device (a JAX process reserves most of a
GPU's memory, so a child started while the parent holds the card would
fail).  Results are written as YAML-ish JSON under tests/results/.

Per method three timings are recorded:
  time         host-complete interpolate() (reference contract)
  device_time  device-complete prepare_interpolator(device_out=True)
               synced by block_until_ready
  time_f32     host-complete with delivery_f32 (documented non-parity
               half-byte delivery knob)

Run directly:  python tests/performance_harness.py [--families hexa,tetra]
                [--levels 8,16,32] [--methods idw,ls,gls] [--repeats 3]
                [--rss subprocess|inprocess|none]
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def peak_rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def vmhwm_mb():
    """Peak RSS of THIS process from the kernel's high-water mark."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM"):
                return int(line.split()[1]) / 1024.0
    return peak_rss_mb()


def _build_case(fam, n, case_name, seed):
    from ninpol_tpu.interpolator import Interpolator
    from ninpol_tpu.utils import meshgen
    from utils.cases import ALHCase, LINCase, QUADCase, FANCase

    case_cls = {"ALH": ALHCase, "LIN": LINCase, "QUAD": QUADCase,
                "FAN": FANCase}[case_name]
    case = case_cls()
    case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=seed)
    interp = Interpolator()
    t0 = time.perf_counter()
    interp.load_mesh(mesh_obj=case.mesh)
    return case, interp, time.perf_counter() - t0


def subprocess_rss(fam, n, method, case_name, seed):
    """Reference-style memory measurement: run ONE workload in a fresh
    subprocess and report its peak RSS (VmHWM)."""
    code = (
        "import sys; sys.argv=['x']; "
        f"sys.path[:0]={[os.path.dirname(os.path.abspath(__file__)), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]!r}; "
        "import performance_harness as ph; "
        f"case, interp, _ = ph._build_case({fam!r}, {n}, {case_name!r}, {seed}); "
        f"interp.interpolate(case.name, {method!r}); "
        "import json; print('RSSJSON ' + json.dumps({'vmhwm_mb': ph.vmhwm_mb()}))"
    )
    try:
        out = subprocess.run(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=3600,
            env=dict(os.environ))
        for line in out.stdout.splitlines():
            if line.startswith("RSSJSON "):
                return json.loads(line[8:])["vmhwm_mb"]
        print("  [rss subprocess gave no result]\n" + out.stdout[-2000:],
              flush=True)
    except subprocess.TimeoutExpired:
        print("  [rss subprocess timed out]", flush=True)
    return None


def run(families, levels, methods, repeats, case_name="ALH", seed=0,
        rss="inprocess"):
    # RSS children first, while this process is still off the device
    child_rss = {}
    if rss in ("subprocess", "subprocess-last"):
        print("rss: one fresh subprocess per workload, all run before "
              "this process touches the device", flush=True)
        for fam in families:
            for n in (levels if rss == "subprocess" else levels[-1:]):
                for m in methods:
                    child_rss[(fam, n, m)] = subprocess_rss(
                        fam, n, m, case_name, seed)
    else:
        print(f"rss: {rss} (no child processes)", flush=True)

    results = {}
    for fam in families:
        results[fam] = {"sizes": [], "points": [], "build": [],
                        "methods": {m: {"time": [], "device_time": [],
                                        "time_f32": [], "error": [],
                                        "memory": []}
                                    for m in methods}}
        for n in levels:
            case, interp, build = _build_case(fam, n, case_name, seed)
            grid = interp.grid
            results[fam]["sizes"].append(grid.n_elems)
            results[fam]["points"].append(grid.n_points)
            results[fam]["build"].append(round(build, 4))
            print(f"[{fam} n={n}] {grid.n_elems} cells "
                  f"{grid.n_points} pts build {build:.2f}s", flush=True)
            tp = np.arange(grid.n_points)
            for m in methods:
                rec = results[fam]["methods"][m]
                interp.interpolate(case.name, m)  # warmup/compile
                times = []
                for _ in range(repeats):
                    # honest repeats: defeat the prepared-weights cache
                    interp._prep_cache = {}
                    t0 = time.perf_counter()
                    W, _ = interp.interpolate(case.name, m)
                    times.append(time.perf_counter() - t0)
                err = case.evaluate(W)
                rec["time"].append(round(min(times), 4))
                rec["error"].append(float(err))
                # device-complete: no host delivery
                dtimes = []
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    interp.prepare_interpolator(
                        m, case.name, tp, device_out=True).block_until_ready()
                    dtimes.append(time.perf_counter() - t0)
                rec["device_time"].append(round(min(dtimes), 4))
                # f32 host delivery (non-parity knob)
                interp.delivery_f32 = True
                ftimes = []
                for _ in range(repeats):
                    interp._prep_cache = {}
                    t0 = time.perf_counter()
                    interp.interpolate(case.name, m)
                    ftimes.append(time.perf_counter() - t0)
                interp.delivery_f32 = False
                rec["time_f32"].append(round(min(ftimes), 4))
                if (fam, n, m) in child_rss:
                    rec["memory"].append(child_rss[(fam, n, m)])
                elif rss == "inprocess":
                    rec["memory"].append(round(peak_rss_mb(), 1))
                else:
                    rec["memory"].append(None)
                print(f"    {m}: host {min(times):.3f}s device "
                      f"{min(dtimes):.3f}s f32 {min(ftimes):.3f}s "
                      f"err={err:.3e} mem={rec['memory'][-1:]}",
                      flush=True)
        results[fam]["peak_rss_mb"] = round(peak_rss_mb(), 1)
    results["peak_rss_mb"] = round(peak_rss_mb(), 1)
    results["rss_methodology"] = (
        "fresh-subprocess VmHWM per (family,level,method), like the "
        "reference" if rss == "subprocess" else rss)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default="hexa,tetra,prism")
    ap.add_argument("--levels", default="8,16")
    ap.add_argument("--methods", default="idw,ls,gls")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--case", default="ALH")
    ap.add_argument("--rss", default="subprocess",
                    choices=["subprocess", "subprocess-last", "inprocess",
                             "none"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    results = run(args.families.split(","),
                  [int(x) for x in args.levels.split(",")],
                  args.methods.split(","), args.repeats, args.case,
                  rss=args.rss)
    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results",
        "performance.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", out)


if __name__ == "__main__":
    main()
