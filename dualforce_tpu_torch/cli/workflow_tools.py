"""Standalone workflow-step CLI (counterpart of `scripts/workflow_tools.py`,
subcommand for subcommand and flag for flag; behavioural reference:
workflow/generate_first_frame.py subcommands prompt/generate/full,
workflow/qwen_vl_api.py, workflow/prompt_rewriter_with_image.py).

Subcommands:
  prompt   — user idea -> first-frame image prompt (stdout or --output)
  generate — image prompt -> first-frame image file
  full     — idea -> prompt -> image in one go
  extract  — image -> visual-element description (json or txt)
  rewrite  — idea [+ elements file] -> full video description

Backends resolve from the environment exactly like the reference
(GEMINI_API_KEY / DASHSCOPE_API_KEY; see workflow/config.py), plus any
OpenAI-compatible endpoint via DUALFORCE_LLM_* / DUALFORCE_IMAGE_*.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys

from dualforce_tpu_torch.workflow.config import WorkflowConfig
from dualforce_tpu_torch.workflow.llm_helpers import (
    extract_visual_elements,
    first_frame_prompt,
    generate_first_frame,
    rewrite_prompt,
)


def _write_or_print(text: str, output: str | None):
    if output:
        os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
        with open(output, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"saved: {output}", file=sys.stderr)
    else:
        print(text)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dualforce_tpu_torch.cli.workflow_tools",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prompt", help="idea -> first-frame image prompt")
    p.add_argument("--user-input", required=True)
    p.add_argument("--output", default=None)

    g = sub.add_parser("generate", help="image prompt -> first-frame image")
    g.add_argument("--image-prompt", required=True)
    g.add_argument("--output", default="generated_first_frame.png")
    g.add_argument("--width", type=int, default=1280)
    g.add_argument("--height", type=int, default=720)

    f = sub.add_parser("full", help="idea -> prompt -> first-frame image")
    f.add_argument("--user-input", required=True)
    f.add_argument("--output", default="generated_first_frame.png")
    f.add_argument("--output-image-prompt", default=None)
    f.add_argument("--width", type=int, default=1280)
    f.add_argument("--height", type=int, default=720)

    e = sub.add_parser("extract", help="image -> visual elements")
    e.add_argument("--image", required=True)
    e.add_argument("--output", required=True, help=".json or .txt")
    e.add_argument("--format", choices=["json", "text"], default=None)

    r = sub.add_parser("rewrite", help="idea [+elements] -> video description")
    r.add_argument("--user-input", required=True)
    r.add_argument("--elements", default=None,
                   help="file with the first-frame element description")
    r.add_argument("--output", default=None)

    args = ap.parse_args(argv)
    cfg = WorkflowConfig()

    if args.cmd == "prompt":
        _write_or_print(first_frame_prompt(args.user_input, cfg), args.output)
    elif args.cmd in ("generate", "full"):
        if args.cmd == "full":
            image_prompt = first_frame_prompt(args.user_input, cfg)
            if args.output_image_prompt:
                _write_or_print(image_prompt, args.output_image_prompt)
        else:
            image_prompt = args.image_prompt
        data = generate_first_frame(image_prompt, args.width, args.height,
                                    cfg, author_prompt=False)
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "wb") as fh:
            fh.write(data)
        print(f"first frame saved: {args.output}")
    elif args.cmd == "extract":
        with open(args.image, "rb") as fh:
            b64 = base64.b64encode(fh.read()).decode()
        desc = extract_visual_elements(b64, cfg)
        fmt = args.format or ("text" if args.output.endswith(".txt")
                              else "json")
        if fmt == "json":
            _write_or_print(json.dumps(
                {"visual_description": desc, "image_path": args.image},
                ensure_ascii=False, indent=2), args.output)
        else:
            _write_or_print(desc, args.output)
    elif args.cmd == "rewrite":
        elements = None
        if args.elements:
            with open(args.elements, encoding="utf-8") as fh:
                raw = fh.read()
            try:
                elements = json.loads(raw).get("visual_description", raw)
            except (ValueError, AttributeError):
                elements = raw
        _write_or_print(
            rewrite_prompt(args.user_input, cfg,
                           first_frame_elements=elements), args.output)


if __name__ == "__main__":
    main()
