"""Readings that a cell's limits are set from, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 12 --control-seeds 3 --first-seed <n>

For each seed: the weights and the inputs of a call as a run draws them,
the program's timed call, the plain float32 reference, and the numbers a
run compares (the program's readings). On the first ``--control-seeds``
seeds also the control: the reference put in the program's place one
precision below what the configuration states (fp8 operands in the UNet,
bf16 in the decoder), against the same float32 reference. Prints one line
per reading and, last, a JSON line with the lower reading (the program's
largest), the upper (the control's smallest) and their ratio per number.
On the card; :func:`readings` also takes the CPU, for tests at small
sizes.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from benchmark import manifest

def readings(cell: manifest.Cell, seeds, control_seeds, device, log=print):
    """{'program': {number: [per seed]}, 'control': {number: [per seed]}}."""
    config, traffic = cell.config, cell.traffic
    driver = importlib.import_module(f"{manifest.PKG}.drivers.{config['family']}")
    reference = importlib.import_module(f"{manifest.PKG}.reference.{config['family']}")
    out = {"program": {}, "control": {}}
    model = ref = None
    for k, seed in enumerate(seeds):
        weights = reference.seeded_state_dict(config, seed, device)
        if model is None:
            driver.set_precision(config)
            model = driver.build(config, weights, device)
            ref = reference.build(config, weights, device)
        else:
            model.load_state_dict(weights, strict=True)
            ref.load_state_dict(weights, strict=True)
        inputs = reference.make_inputs(config, traffic, seed, 0, device)
        driver.set_precision(config)
        t0 = time.perf_counter()
        got = driver.call(model, config, inputs)
        t1 = time.perf_counter()
        ref.set_precision("f32", "f32")
        want = ref.sample(inputs)
        values = reference.judge(ref, inputs, got, want)
        t2 = time.perf_counter()
        for name, v in values.items():
            out["program"].setdefault(name, []).append(v)
        log(f"program seed {seed}: " + " ".join(f"{n} {v!r}" for n, v in values.items())
            + f" (call {t1 - t0:.2f} s, reference {t2 - t1:.2f} s)")
        if k < control_seeds:
            ref.set_precision(*reference.CONTROL_PRECISION)
            control = ref.sample(inputs)
            ref.set_precision("f32", "f32")
            values = reference.judge(ref, inputs, control, want)
            for name, v in values.items():
                out["control"].setdefault(name, []).append(v)
            log(f"control seed {seed}: " + " ".join(f"{n} {v!r}" for n, v in values.items())
                + f" ({time.perf_counter() - t2:.2f} s)")
        del got, want, inputs
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=1)
    args = p.parse_args(argv)
    cell = manifest.resolve(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    r = readings(cell, seeds, args.control_seeds, "cuda", log=lambda s: print(s, flush=True))
    summary = {}
    for name, values in r["program"].items():
        lower = max(values)
        upper = min(r["control"].get(name, [float("nan")]))
        summary[name] = {"lower": lower, "upper": upper, "ratio": upper / lower}
    print(json.dumps({"workload": cell.name, "seeds": seeds, "readings": r,
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
