"""External-LLM helper steps of the full workflow (the port's copy of
`dualforce_tpu/workflow/llm_helpers.py`; behavioural reference:
workflow/{generate_first_frame,prompt_rewriter_with_image,qwen_vl_api}.py):
first-frame prompt authoring + image synthesis, visual-element extraction,
and the first-frame-conditioned video-description rewrite. Provider routing
(Gemini > DashScope qwen/Z-Image/Qwen3-VL > OpenAI-compatible) lives in
workflow/providers.py; every step keeps a deterministic local fallback so
the end-to-end workflow runs without egress.

The system prompts cover the same contract as the reference's (required
camera parameters, faithful element coverage, verbatim dialogue/OCR, the
closing audio paragraph) but are written for this project.
"""

from __future__ import annotations

from typing import Optional

from dualforce_tpu_torch.workflow.config import WorkflowConfig
from dualforce_tpu_torch.workflow.providers import chat_any, image_any

# --------------------------------------------------------------------------
# Step 1a: user description -> first-frame IMAGE prompt
# (generate_first_frame.py `prompt` subcommand role)
# --------------------------------------------------------------------------

FIRST_FRAME_PROMPT_SYSTEM = (
    "You turn a short video idea into one prompt for an image-generation "
    "model that depicts the video's FIRST frame only.\n"
    "Requirements:\n"
    "- Cover every visual detail the idea mentions (subjects, their pose "
    "and appearance, objects, setting, any on-screen text) — omit none, "
    "invent no major new ones.\n"
    "- State the shot size (close-up / medium / long / wide ...) and the "
    "camera angle (eye-level / high / low / bird's-eye ...) explicitly; "
    "choose sensible ones if the idea doesn't say.\n"
    "- Describe lighting, palette and mood consistent with the idea.\n"
    "- Present tense, a single static moment: no 'then', no sound, no "
    "story progression. Freeze any described action at its first instant.\n"
    "- Output one paragraph of 100-250 words, starting with the camera "
    "framing. Output the prompt text only.")


def first_frame_prompt(user_input: str,
                       cfg: Optional[WorkflowConfig] = None) -> str:
    """User description -> first-frame image-generation prompt. Falls back
    to the raw description when no LLM endpoint is configured."""
    cfg = cfg or WorkflowConfig()
    try:
        reply, _ = chat_any(cfg, FIRST_FRAME_PROMPT_SYSTEM, user_input)
        return reply.strip() or user_input
    except LookupError:
        return user_input


# --------------------------------------------------------------------------
# Step 1b: image prompt -> first-frame image
# (generate_first_frame.py `generate` subcommand role)
# --------------------------------------------------------------------------

def generate_first_frame(prompt: str, width: int, height: int,
                         cfg: Optional[WorkflowConfig] = None,
                         author_prompt: bool = True) -> bytes:
    """Text -> first-frame PNG bytes, via the reference's two-stage flow
    (`full`): author an image prompt with the text LLM, then synthesize on
    the first available image backend (Gemini Flash Image / Z-Image /
    OpenAI-compatible). Local fallback: a neutral gradient frame so the
    end-to-end workflow still runs without egress."""
    cfg = cfg or WorkflowConfig()
    image_prompt = first_frame_prompt(prompt, cfg) if author_prompt else prompt
    try:
        data, _ = image_any(cfg, image_prompt, width, height)
        return data
    except LookupError:
        pass
    # offline fallback: deterministic gradient
    import io

    import numpy as np
    from PIL import Image

    y = np.linspace(60, 180, height)[:, None]
    x = np.linspace(80, 200, width)[None, :]
    img = np.stack([y + 0 * x, 0 * y + x, (y + x) / 2], axis=-1).astype("uint8")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


# --------------------------------------------------------------------------
# Step 2: first frame -> visual-element description (qwen_vl_api.py role)
# --------------------------------------------------------------------------

EXTRACT_SYSTEM = (
    "Describe ONLY what is visibly present in this image, as a concise "
    "factual paragraph in English, covering in order:\n"
    "1. Visual style: art style, palette, color temperature, image "
    "quality.\n"
    "2. Camera: shot size, camera angle, composition, depth of field, "
    "camera position.\n"
    "3. Elements: people (appearance, pose), key objects and their "
    "positions, the setting, lighting, spatial relationships.\n"
    "4. Text/OCR: every readable piece of text, quoted EXACTLY as it "
    "appears — never translated, transliterated, or annotated; note its "
    "position and look.\n"
    "No speculation, no interpretation, no content that is not directly "
    "visible.")


def extract_visual_elements(image_b64: str,
                            cfg: Optional[WorkflowConfig] = None) -> str:
    """Visual-element extraction from the first frame. Returns "" when no
    vision-capable endpoint is configured."""
    cfg = cfg or WorkflowConfig()
    try:
        reply, _ = chat_any(cfg, None, EXTRACT_SYSTEM, image_b64=image_b64)
        return reply.strip()
    except LookupError:
        return ""


# --------------------------------------------------------------------------
# Step 3: idea + first-frame elements -> full video description
# (prompt_rewriter_with_image.py role)
# --------------------------------------------------------------------------

REWRITE_SYSTEM = (
    "You are a prompt engineer for an audio-video generation model. "
    "Rewrite the user's idea into a rich video description, at most 250 "
    "words, in paragraphs:\n"
    "- Opening paragraph: weave the first frame's essential state (subjects, "
    "setting, lighting, shot size, camera angle, any visible text verbatim) "
    "into flowing narration with active verbs — never a bullet inventory, "
    "and never contradicting or restyling the provided first frame.\n"
    "- Middle paragraph(s): the scene's chronological progression from the "
    "user's idea, keeping the first frame's visual style throughout; "
    "mention camera moves or cuts only if the input calls for them.\n"
    "- Dialogue, if any, in double quotes EXACTLY as the user wrote it — "
    "no invented lines, no translation or phonetic annotation.\n"
    "- Final paragraph: audio only, starting with 'The audio shows', "
    "covering music, ambience, effects and timing the user described — "
    "and nothing they didn't.\n"
    "Be concrete and observable; avoid abstract language and words that "
    "imply a frozen image (static, still, motionless). Assume real-world "
    "lighting, acoustics and physics unless told otherwise. Output the "
    "description only.")

REWRITE_USER_TEMPLATE = (
    "First-frame visual elements (preserve, do not contradict):\n"
    "{elements}\n\n"
    "User's idea (defines the progression):\n{idea}\n\n"
    "Write the full video description.")


def rewrite_prompt(prompt: str, cfg: Optional[WorkflowConfig] = None,
                   image_b64: Optional[str] = None,
                   first_frame_elements: Optional[str] = None) -> str:
    """Prompt rewriting, optionally conditioned on the first frame — either
    its extracted element description (preferred; the reference's
    prompt_rewriter_with_image contract) or the raw image for multimodal
    backends. Falls back to the input prompt when no LLM endpoint is
    configured or every backend fails."""
    cfg = cfg or WorkflowConfig()
    if first_frame_elements:
        text = REWRITE_USER_TEMPLATE.format(elements=first_frame_elements,
                                            idea=prompt)
    else:
        text = prompt
    try:
        reply, _ = chat_any(cfg, REWRITE_SYSTEM, text, image_b64=image_b64)
        return reply.strip() or prompt
    except LookupError:
        return prompt
