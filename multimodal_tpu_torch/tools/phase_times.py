"""Each phase's wall seconds of another checkout's ``chip_smoke.py``, for a
tree whose script does not print its ``phases:`` line itself.

    python multimodal_tpu_torch/tools/phase_times.py DIR

runs DIR's ``chip_smoke.py`` in this process, from DIR and on DIR's
package, with each of its phase functions in ``PHASES`` that it has timed,
and prints, after the script's own output, ``phases: wall seconds {...}``
as the script's line gives them: ``build``, ``kernel_cases`` (phase 2, from
the build's end to the first path) and each phase by its function's name.
Run it by its path, not with ``-m``, so that this tree's package is not
imported; like the script, it needs the card."""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import time

PHASES = ("serve", "train", "vit_b16_grad_check", "vit_l14_check", "lm_serve", "lm_train",
          "flava_train", "flava_real", "zero_shot", "albef", "coca_phase", "blip2_phase",
          "mugen_phase", "mdetr_phase", "t2v_phase", "vqa_phase")


class _Tee:
    """Standard output passed through, the script's build line kept."""

    def __init__(self, out, times):
        self.out, self.times = out, times

    def write(self, text):
        m = re.match(r"build: \S+ in ([0-9.]+) s", text)
        if m:
            self.times["build"] = float(m.group(1))
            self.times["_built_at"] = time.perf_counter()
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    sys.argv = [os.path.join(root, "chip_smoke.py")]
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[0])
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    times = {}

    def timed(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            if "_built_at" in times:  # phase 2 ends where the first path starts
                times["kernel_cases"] = round(t0 - times.pop("_built_at"), 1)
            out = fn(*args, **kwargs)
            times[fn.__name__] = round(time.perf_counter() - t0, 1)
            return out
        return run

    for name in PHASES:
        if hasattr(cs, name):
            setattr(cs, name, timed(getattr(cs, name)))
    sys.stdout = _Tee(sys.stdout, times)
    try:
        cs.main()
    finally:
        sys.stdout = sys.stdout.out
        times.pop("_built_at", None)
        print(f"phases: wall seconds {json.dumps(times)}", flush=True)


if __name__ == "__main__":
    main()
