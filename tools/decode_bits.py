#!/usr/bin/env python3
"""Compare the decode attention kernel's outputs (without ``return_lse``)
of two checkouts bit for bit, on one card.

    python3 tools/decode_bits.py ROOT_A ROOT_B

Each ROOT is a checkout of this repository; each runs in a subprocess of
its own (the checkouts share module names), builds its decode kernel and
runs ``ops.decode_attention`` on the same seeded inputs: fp32 and bf16, the
serving shapes and their edges (olmo-1b's 16:16 and a rank's 8:8 of 128,
zamba2-7b's 16:16 of 112, GQA 4:1 at 112 and 2:1 at 64, llama4-scout's
40:8, a 16-position buffer, a batch-1 shard of 16384 positions, one kv
head), rows of cache_len 0, 1, the whole buffer and half of it plus 3, at
the kernel's own split and at splits of 32 and 64. Prints how many outputs
it compared, those that differ (none when the kernels compute alike), and
the card's name and power limit; exits 1 if any differ.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

# (B, S, H, KV, D)
CASES = [(4, 1024, 16, 16, 128), (4, 1024, 8, 8, 128), (3, 300, 16, 4, 112),
         (2, 512, 4, 2, 64), (4, 256, 40, 8, 128), (4, 16, 16, 16, 112),
         (1, 16384, 32, 8, 128), (2, 64, 4, 1, 64)]


def outputs(root: Path, out: Path) -> None:
    """This root's decode outputs, as their fp32 bits, to ``out`` (npz)."""
    sys.path[:0] = [str(root / "src")]
    import numpy as np
    import torch

    from repro_torch.kernels import _build, ops
    _build.build(["decode_attention"])
    dev = torch.device("cuda")
    got = {}
    for i, (b, s, h, kv, d) in enumerate(CASES):
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(i)
            q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dt)
            kc = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dt)
            vc = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dt)
            lens = torch.tensor(([0, 1, s, s // 2 + 3] * 2)[:b],
                                dtype=torch.int32, device=dev)
            for split in (None, 32, 64):
                o = ops.decode_attention(q, kc, vc, lens, **(
                    {} if split is None else {"split": split}))
                torch.cuda.synchronize()
                got[f"{i}/{dt}/{split}"] = o.float().cpu().numpy().view(
                    np.uint32)
    np.savez(out, **got)


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--outputs":
        outputs(Path(argv[1]).resolve(), Path(argv[2]))
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, root in enumerate(argv):
            files.append(Path(tmp, f"{i}.npz"))
            subprocess.run([sys.executable, __file__, "--outputs",
                            str(Path(root).resolve()), str(files[-1])],
                           check=True)
        a, b = np.load(files[0]), np.load(files[1])
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
        print(f"decode outputs compared: {len(a.files)}; differ: {differ}")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
