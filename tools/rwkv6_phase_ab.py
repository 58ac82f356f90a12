#!/usr/bin/env python3
"""chip_smoke.py's RWKV6 state-sharing phase (or with ``--zamba2`` its
Zamba2 phase) from two checkouts in turns (parent, change, change, parent)
on one card, each run its own process:

    mkdir -p build/parent_tree && git archive HEAD~1 | tar -x -C build/parent_tree
    mkdir -p build/change_tree && git archive HEAD | tar -x -C build/change_tree
    python3 tools/rwkv6_phase_ab.py build/parent_tree build/change_tree
    python3 tools/rwkv6_phase_ab.py build/parent_tree build/change_tree \
        --zamba2

Each run builds the phase's kernel (K4; K1 for Zamba2) in its checkout and
prints, as JSON lines, the in-memory round's stage times (host clock:
sender and receiver prefill, a decode step, tokens/s), the phase's seconds
with K4's device ms at T 2049 (RWKV6) or K1's launches (Zamba2), and the
seconds of the phase's gate with its planted faults where it has one."""
import json
import subprocess
import sys

CODE = r'''
import sys, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.launch import pairs
_build.load_all((KERNEL,))
dev = torch.device("cuda")
scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
cs.PHASE(dev, cs.smi_line(), lambda: scratch.zero_(), pairs.pair_tokenizer())
'''
# model: (kernel, phase function, the phase's line and its kernel reading)
PHASES = {"rwkv6": ("rwkv_scan", "phase_rwkv6_state_sharing",
                    "state_sharing_rwkv6", "k4_device_ms_T2049"),
          "zamba2": ("ragged_decode", "phase_zamba2_state_sharing",
                     "state_sharing_zamba2", "k1_launches")}


def main(parent, change, model="rwkv6"):
    kernel, phase, line, reading = PHASES[model]
    code = CODE.replace("KERNEL", repr(kernel)).replace("PHASE", phase)
    for name, tree in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode:
            print(name, "rc", out.returncode, out.stderr[-2000:], flush=True)
            return out.returncode
        for text in out.stdout.splitlines():
            if not text.startswith("{"):
                continue
            d = json.loads(text)
            if d.get("transport") == "inmemory":
                print(json.dumps({"tree": name, **{k: d[k] for k in (
                    "sender_prefill_ms", "receiver_prefill_ms",
                    "decode_step_ms", "tokens_per_s", "generate_ms",
                    "share_ms")}}), flush=True)
            elif d.get("phase") == line:
                print(json.dumps({"tree": name, "phase_s": d["seconds"],
                                  reading: d[reading]}), flush=True)
            elif d.get("phase") == f"{line}_faults":
                print(json.dumps({"tree": name, "gate_s": d["seconds"]}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3],
                  *(["zamba2"] if "--zamba2" in sys.argv else [])))
