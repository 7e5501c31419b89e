"""Emit deploy/crd.yaml from the port's typed API model.

The same schema derivation as ``tools/gen_crd.py``, from
``kube_throttler_tpu_torch/api/crd.py``: the port's dataclasses must
produce the committed ``deploy/crd.yaml`` byte for byte.

    python tools/gen_crd_torch.py [--out PATH]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import yaml

from kube_throttler_tpu_torch.api import crd


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--out",
        default=str(Path(__file__).resolve().parent.parent / "deploy" / "crd.yaml"),
    )
    out = Path(parser.parse_args(argv).out)
    docs = [crd.cluster_throttle_crd(), crd.throttle_crd()]
    text = "---\n" + "---\n".join(
        yaml.safe_dump(d, sort_keys=True, default_flow_style=False) for d in docs
    )
    out.parent.mkdir(exist_ok=True)
    out.write_text(text)
    print(f"wrote {out} ({len(text.splitlines())} lines, {len(docs)} documents)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
