"""Workflow configuration (the port's copy of `dualforce_tpu/workflow/config.py`;
behavioural reference: workflow/config.py:16-120 —
server endpoint + external LLM API keys via env vars)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env(name: str, default: str = ""):
    # default_factory: read the environment at INSTANTIATION time, not at
    # import time — launchers commonly set os.environ after imports
    return field(default_factory=lambda: os.environ.get(name, default))


def _env_float(name: str, default: str):
    return field(default_factory=lambda: float(os.environ.get(name, default)))


@dataclass
class WorkflowConfig:
    server_url: str = _env("DUALFORCE_SERVER_URL", "http://127.0.0.1:8000")
    poll_interval_s: float = _env_float("DUALFORCE_POLL_INTERVAL", "5")
    task_timeout_s: float = _env_float("DUALFORCE_TASK_TIMEOUT", "1800")
    output_dir: str = _env("DUALFORCE_OUTPUT_DIR", "./workflow_outputs")

    # External LLM providers (first-frame gen / element extraction / prompt
    # rewrite). Native adapters for the reference's two backends — Gemini and
    # DashScope (workflow/config.py:59-101, api_utils.py:12-26; same env-var
    # contract: GEMINI_API_KEY/GEMINI_API_URL, DASHSCOPE_API_KEY/
    # DASHSCOPE_BASE_URL) — plus any OpenAI-compatible endpoint.
    gemini_api_key: str = _env("GEMINI_API_KEY")
    gemini_api_base: str = _env("GEMINI_API_URL",
                                "https://generativelanguage.googleapis.com")
    gemini_text_model: str = _env("GEMINI_MODEL", "gemini-2.5-pro")
    gemini_image_model: str = _env("GEMINI_IMAGE_MODEL",
                                   "gemini-2.5-flash-image")
    dashscope_api_key: str = _env("DASHSCOPE_API_KEY")
    dashscope_api_base: str = _env("DASHSCOPE_BASE_URL",
                                   "https://dashscope.aliyuncs.com/api/v1")
    dashscope_text_model: str = _env("DASHSCOPE_TEXT_MODEL", "qwen-plus")
    dashscope_vision_model: str = _env("DASHSCOPE_VISION_MODEL",
                                       "qwen3-vl-plus")
    dashscope_image_model: str = _env("DASHSCOPE_IMAGE_MODEL",
                                      "z-image-turbo")
    llm_api_base: str = _env("DUALFORCE_LLM_API_BASE")
    llm_api_key: str = _env("DUALFORCE_LLM_API_KEY")
    llm_model: str = _env("DUALFORCE_LLM_MODEL")
    image_api_base: str = _env("DUALFORCE_IMAGE_API_BASE")
    image_api_key: str = _env("DUALFORCE_IMAGE_API_KEY")
    image_model: str = _env("DUALFORCE_IMAGE_MODEL")

    @property
    def gemini_available(self) -> bool:
        return bool(self.gemini_api_key)

    @property
    def dashscope_available(self) -> bool:
        return bool(self.dashscope_api_key)

    @property
    def openai_chat_available(self) -> bool:
        return bool(self.llm_api_base and self.llm_api_key)

    @property
    def openai_image_available(self) -> bool:
        return bool(self.image_api_base and self.image_api_key)

    @property
    def llm_available(self) -> bool:
        return bool(self.gemini_api_key or self.dashscope_api_key
                    or self.openai_chat_available)

    @property
    def image_gen_available(self) -> bool:
        return bool(self.gemini_api_key or self.dashscope_api_key
                    or self.openai_image_available)
