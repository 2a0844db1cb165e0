"""External-LLM provider adapters for the full workflow (the port's copy of
`dualforce_tpu/workflow/providers.py`).

Behavioural reference: workflow/{generate_first_frame.py:110-352,
prompt_rewriter_with_image.py:177-260, qwen_vl_api.py:70-130,
api_utils.py:12-34} — the reference routes each workflow step by key
availability: a Gemini key selects the google-genai client, otherwise a
DashScope key selects qwen-plus / Z-Image / Qwen3-VL. Here the same three
provider surfaces are spoken natively over plain REST (stdlib urllib, no
google-genai/dashscope/requests deps), plus a generic OpenAI-compatible
endpoint the reference doesn't have, so ANY of the four backends can serve
each step. Routing priority matches the reference: Gemini > DashScope >
OpenAI-compatible > offline fallback.
"""

from __future__ import annotations

import base64
import json
import urllib.request
from typing import List, Optional, Tuple

from dualforce_tpu_torch.workflow.config import WorkflowConfig

# Z-Image accepts only these sizes (generate_first_frame.py:197-200) and
# caps prompts at 800 chars (generate_first_frame.py:232-234).
ZIMAGE_ASPECT_TO_SIZE = {"16:9": "1280*720", "9:16": "720*1280"}
ZIMAGE_MAX_PROMPT = 800


def _post_json(url: str, payload: dict, headers: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


# ---------------------------------------------------------------------------
# Gemini (REST generateContent; ≡ google-genai client usage in the reference)
# ---------------------------------------------------------------------------

def gemini_generate_text(cfg: WorkflowConfig, system: Optional[str],
                         parts: List[dict], model: Optional[str] = None,
                         timeout: float = 60.0) -> str:
    """system + user parts -> text. `parts` entries are Gemini part dicts:
    {"text": ...} or {"inline_data": {"mime_type", "data"(b64)}}."""
    model = model or cfg.gemini_text_model
    payload = {"contents": [{"role": "user", "parts": parts}]}
    if system:
        payload["system_instruction"] = {"parts": [{"text": system}]}
    data = _post_json(
        f"{cfg.gemini_api_base.rstrip('/')}/v1beta/models/{model}"
        ":generateContent",
        payload, {"x-goog-api-key": cfg.gemini_api_key}, timeout)
    out = []
    for part in data["candidates"][0]["content"]["parts"]:
        if "text" in part:
            out.append(part["text"])
    text = "".join(out).strip()
    if not text:
        raise ValueError("Gemini returned no text")
    return text


def gemini_generate_image(cfg: WorkflowConfig, prompt: str,
                          aspect_ratio: str = "16:9",
                          timeout: float = 120.0) -> bytes:
    """Text -> PNG bytes via the image model (reference uses
    gemini-2.5-flash-image with an aspect-ratio image config,
    generate_first_frame.py:318-339)."""
    payload = {
        "contents": [{"role": "user", "parts": [{"text": prompt}]}],
        "generationConfig": {"imageConfig": {"aspectRatio": aspect_ratio}},
    }
    data = _post_json(
        f"{cfg.gemini_api_base.rstrip('/')}/v1beta/models/"
        f"{cfg.gemini_image_model}:generateContent",
        payload, {"x-goog-api-key": cfg.gemini_api_key}, timeout)
    for part in data["candidates"][0]["content"]["parts"]:
        inline = part.get("inlineData") or part.get("inline_data")
        if inline and inline.get("data"):
            return base64.b64decode(inline["data"])
    raise ValueError("Gemini returned no image data")


# ---------------------------------------------------------------------------
# DashScope (qwen-plus chat, Qwen3-VL multimodal, Z-Image generation)
# ---------------------------------------------------------------------------

def _dashscope_headers(cfg: WorkflowConfig) -> dict:
    return {"Authorization": f"Bearer {cfg.dashscope_api_key}"}


def _check_dashscope(data: dict) -> dict:
    if data.get("code"):
        raise RuntimeError(f"DashScope error: {data.get('message', data)}")
    return data


def dashscope_chat(cfg: WorkflowConfig, system: Optional[str], user: str,
                   model: Optional[str] = None, timeout: float = 60.0) -> str:
    """Text chat (qwen-plus path, generate_first_frame.py:149-193)."""
    messages = ([{"role": "system", "content": system}] if system else []) \
        + [{"role": "user", "content": user}]
    data = _check_dashscope(_post_json(
        f"{cfg.dashscope_api_base.rstrip('/')}"
        "/services/aigc/text-generation/generation",
        {"model": model or cfg.dashscope_text_model,
         "input": {"messages": messages},
         "parameters": {"result_format": "message"}},
        _dashscope_headers(cfg), timeout))
    text = (data["output"]["choices"][0]["message"]["content"] or "").strip()
    if not text:
        raise ValueError("DashScope returned an empty message")
    return text


def dashscope_vision(cfg: WorkflowConfig, image_b64: str, question: str,
                     model: Optional[str] = None,
                     timeout: float = 120.0) -> str:
    """Image + text -> text (Qwen3-VL extraction path, qwen_vl_api.py:70-124;
    the reference passes a file:// path through the dashscope SDK — the REST
    equivalent inlines the image as a data URL)."""
    content = [{"image": f"data:image/png;base64,{image_b64}"},
               {"text": question}]
    data = _check_dashscope(_post_json(
        f"{cfg.dashscope_api_base.rstrip('/')}"
        "/services/aigc/multimodal-generation/generation",
        {"model": model or cfg.dashscope_vision_model,
         "input": {"messages": [{"role": "user", "content": content}]}},
        _dashscope_headers(cfg), timeout))
    parts = data["output"]["choices"][0]["message"]["content"]
    return "".join(p.get("text", "") for p in parts).strip()


def dashscope_zimage(cfg: WorkflowConfig, prompt: str,
                     aspect_ratio: str = "16:9",
                     timeout: float = 120.0) -> bytes:
    """Text -> image via Z-Image (generate_first_frame.py:203-281): size from
    the aspect map, prompt truncated to the 800-char API cap, image fetched
    from the returned URL."""
    if len(prompt) > ZIMAGE_MAX_PROMPT:
        prompt = prompt[:ZIMAGE_MAX_PROMPT - 3] + "..."
    data = _check_dashscope(_post_json(
        f"{cfg.dashscope_api_base.rstrip('/')}"
        "/services/aigc/multimodal-generation/generation",
        {"model": cfg.dashscope_image_model,
         "input": {"messages": [{"role": "user",
                                 "content": [{"text": prompt}]}]},
         "parameters": {
             "prompt_extend": False,
             "size": ZIMAGE_ASPECT_TO_SIZE.get(aspect_ratio, "1280*720")}},
        _dashscope_headers(cfg), timeout))
    url = None
    for item in data["output"]["choices"][0]["message"]["content"]:
        if isinstance(item, dict) and "image" in item:
            url = item["image"]
            break
    if not url:
        raise ValueError("Z-Image returned no image URL")
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


# ---------------------------------------------------------------------------
# OpenAI-compatible (beyond-reference generic backend)
# ---------------------------------------------------------------------------

def openai_chat(cfg: WorkflowConfig, system: Optional[str], content,
                max_tokens: int = 512, timeout: float = 60.0) -> str:
    messages = ([{"role": "system", "content": system}] if system else []) \
        + [{"role": "user", "content": content}]
    data = _post_json(
        cfg.llm_api_base.rstrip("/") + "/chat/completions",
        {"model": cfg.llm_model, "messages": messages,
         "max_tokens": max_tokens},
        {"Authorization": f"Bearer {cfg.llm_api_key}"}, timeout)
    return data["choices"][0]["message"]["content"]


def openai_image(cfg: WorkflowConfig, prompt: str, width: int, height: int,
                 timeout: float = 120.0) -> bytes:
    data = _post_json(
        cfg.image_api_base.rstrip("/") + "/images/generations",
        {"model": cfg.image_model, "prompt": prompt,
         "size": f"{width}x{height}", "response_format": "b64_json"},
        {"Authorization": f"Bearer {cfg.image_api_key}"}, timeout)
    return base64.b64decode(data["data"][0]["b64_json"])


# ---------------------------------------------------------------------------
# Routing (reference priority: Gemini > DashScope > OpenAI-compatible)
# ---------------------------------------------------------------------------

def text_providers(cfg: WorkflowConfig) -> List[str]:
    order = []
    if cfg.gemini_available:
        order.append("gemini")
    if cfg.dashscope_available:
        order.append("dashscope")
    if cfg.openai_chat_available:
        order.append("openai")
    return order


def image_providers(cfg: WorkflowConfig) -> List[str]:
    order = []
    if cfg.gemini_available:
        order.append("gemini")
    if cfg.dashscope_available:
        order.append("dashscope")
    if cfg.openai_image_available:
        order.append("openai")
    return order


def chat_any(cfg: WorkflowConfig, system: Optional[str], text: str,
             image_b64: Optional[str] = None) -> Tuple[str, str]:
    """Run a (optionally multimodal) chat on the first available provider,
    falling through on errors. Returns (reply, provider). Raises LookupError
    when no provider is configured."""
    last_err: Optional[Exception] = None
    for prov in text_providers(cfg):
        try:
            if prov == "gemini":
                parts = [{"text": text}]
                if image_b64:
                    parts.insert(0, {"inline_data": {
                        "mime_type": "image/png", "data": image_b64}})
                return gemini_generate_text(cfg, system, parts), prov
            if prov == "dashscope":
                if image_b64:
                    q = (system + "\n\n" + text) if system else text
                    return dashscope_vision(cfg, image_b64, q), prov
                return dashscope_chat(cfg, system, text), prov
            content = [{"type": "text", "text": text}]
            if image_b64:
                content.append({"type": "image_url", "image_url": {
                    "url": f"data:image/png;base64,{image_b64}"}})
            return openai_chat(cfg, system, content), prov
        except Exception as e:  # noqa: BLE001 — fall through to next backend
            last_err = e
    raise LookupError(f"no text provider available (last error: {last_err})")


def image_any(cfg: WorkflowConfig, prompt: str, width: int,
              height: int) -> Tuple[bytes, str]:
    """Generate an image on the first available provider. The reference maps
    the video geometry to an aspect ratio (app.py passes 16:9 or 9:16)."""
    aspect = "9:16" if height > width else "16:9"
    last_err: Optional[Exception] = None
    for prov in image_providers(cfg):
        try:
            if prov == "gemini":
                return gemini_generate_image(cfg, prompt, aspect), prov
            if prov == "dashscope":
                return dashscope_zimage(cfg, prompt, aspect), prov
            return openai_image(cfg, prompt, width, height), prov
        except Exception as e:  # noqa: BLE001
            last_err = e
    raise LookupError(f"no image provider available (last error: {last_err})")
