"""Which of the reference's Unet backbone names the port builds.

Builds ``models.unet.Unet`` for every name of the zoo table
(``models/unet_zoo.__available_models__``) on the ``meta`` device, so no
weight is drawn, with decoder channels (64, 48, 32, 16), and runs an
eval-mode forward of a [1,3,64,96] input there: a name builds when its
output is the half-resolution [1,16,32,48]. The others must raise
``NotImplementedError`` naming ``ROADMAP.md queue 1 item 12``. Names whose
modules print the same (weight-source aliases) are run once. Counterpart
of the JAX package's ``tools/backbone_coverage.py``.

    python -m sfmnext_tpu_torch.tools.backbone_coverage

Prints a line a family (the name's first word) with the names that build
and those that raise, then the totals; exits 1 if a name neither builds
with the contract nor raises as it should.
"""

from __future__ import annotations

import collections
import multiprocessing
import re
import sys
from typing import Dict, List

import torch

from sfmnext_tpu_torch.models.unet import Unet, strip_weight_alias
from sfmnext_tpu_torch.models.unet_zoo import __available_models__

DECODER = (64, 48, 32, 16)
INPUT = (1, 3, 64, 96)
HALF = (1, 16, 32, 48)
ITEM = "ROADMAP.md queue 1 item 12"
# one name per option of the ResNet family, for the forwards on the card
# (chip_smoke.py's zoo phase, tests/test_torch_cuda.py)
OPTION_NAMES = ("resnet26t", "resnet50d", "gluon_resnet50_v1s", "seresnext50_32x4d",
                "ecaresnet50d", "resnetblur50", "resnetaa50", "resnet50_gn", "resnetrs50",
                "wide_resnet50_2", "resnest50d", "resnetv2_50x1_bitm", "resnetv2_50d_evos",
                "res2net50_26w_4s", "skresnext50_32x4d", "legacy_senet154")


def check(names: List[str]) -> Dict[str, str]:
    """{name: "builds" | "raises" | what went wrong} for ``names``."""
    out, shapes = {}, {}
    for name in names:
        try:
            with torch.device("meta"):
                model = Unet(name, DECODER[-1], DECODER).eval()
        except NotImplementedError as e:
            out[name] = "raises" if ITEM in str(e) else f"raises without naming the item: {e}"
            continue
        key = repr(model)
        if key not in shapes:
            with torch.no_grad():
                shapes[key] = tuple(model(torch.zeros(INPUT, device="meta")).shape)
        out[name] = "builds" if shapes[key] == HALF else f"output {shapes[key]}, not {HALF}"
    return out


def coverage(names=__available_models__, workers: int = 1) -> Dict[str, str]:
    """``check`` over ``names``: in this process (about 40 s, the
    meta-device forwards are host-bound), or split over ``workers`` spawned
    processes, which needs the caller's script to guard its entry point
    with ``if __name__ == "__main__"``. A name and its weight-source aliases
    go to the same process, so that they share one forward."""
    if workers == 1:
        return check(list(names))
    groups = collections.defaultdict(list)
    for name in names:
        groups[strip_weight_alias(name)].append(name)
    runs = [[] for _ in range(workers)]
    for i, key in enumerate(sorted(groups)):
        runs[i % workers] += groups[key]
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        parts = pool.map(check, runs)
    merged = {k: v for part in parts for k, v in part.items()}
    return {name: merged[name] for name in names}


def family(name: str) -> str:
    """The routing name up to its first digit (its first word if none)."""
    name = strip_weight_alias(name)
    head = re.match(r"[^0-9]*", name).group(0).rstrip("_")
    return head if head != name else name.split("_")[0]


def main() -> int:
    result = coverage()
    by_family = collections.defaultdict(lambda: collections.defaultdict(list))
    for name, status in result.items():
        by_family[family(name)][status if status in ("builds", "raises") else "wrong"].append(name)
    for fam in sorted(by_family):
        parts = by_family[fam]
        print(f"{fam}: builds {len(parts['builds'])} {parts['builds']}; raises "
              f"{len(parts['raises'])}" + (f"; WRONG {parts['wrong']}" if parts["wrong"] else ""))
    counts = collections.Counter(v if v in ("builds", "raises") else "wrong"
                                 for v in result.values())
    print(f"{len(result)} names: {counts['builds']} build with the half-resolution output, "
          f"{counts['raises']} raise naming {ITEM}, {counts['wrong']} wrong")
    for name, status in result.items():
        if status not in ("builds", "raises"):
            print(f"WRONG {name}: {status}")
    return 1 if counts["wrong"] else 0


if __name__ == "__main__":
    sys.exit(main())
