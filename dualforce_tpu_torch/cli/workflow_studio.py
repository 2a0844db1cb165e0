"""Launch the multi-server studio UI (counterpart of
`scripts/workflow_studio.py`, flag for flag; behavioural reference:
workflow/config.py SGLANG_SERVERS + workflow/launch_streamlit.sh — one
front-end over several model servers, e.g. a 360p and a 720p deployment).

Usage:
    python -m dualforce_tpu_torch.cli.workflow_studio \\
        --servers mova-360p=http://host-a:8000,mova-720p=http://host-b:8000
    # or: DUALFORCE_SERVERS="mova-360p=http://...,..." \\
    #     python -m dualforce_tpu_torch.cli.workflow_studio
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dualforce_tpu_torch.cli.workflow_studio",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--servers", type=str,
                    default=os.environ.get("DUALFORCE_SERVERS", ""),
                    help='"name=url,name=url" registry of DualForce servers')
    ap.add_argument("--active", type=str, default=None,
                    help="initially selected server (default: first)")
    ap.add_argument("--host", type=str, default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8800)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from dualforce_tpu_torch.workflow.studio import Studio, parse_servers

    Studio(parse_servers(args.servers), active=args.active).run(
        host=args.host, port=args.port)


if __name__ == "__main__":
    main()
