"""The port's prompt cleaning against the JAX package's, on the CPU.

`prompt_clean` feeds the tokenizer in both packages, so equal strings mean
equal token ids. Both run the optional `ftfy.fix_text` first where ftfy can
be imported: the test runs once with the environment as it is and once with
a stub `ftfy` module in `sys.modules` (nothing is downloaded), whose
`fix_text` makes a visible change that both packages must show.
"""

import sys
import types

import pytest

from dualforce_tpu.diffusion import pipeline as jax_pipeline
from dualforce_tpu_torch.diffusion import pipeline as torch_pipeline

PROMPTS = [
    "a cat playing the piano in a sunlit room",
    "salt &amp; pepper",
    "double-escaped &amp;amp; entities &amp;lt;b&amp;gt;",
    "&lt;i&gt;tags&lt;/i&gt; &quot;quoted&quot; &#39;single&#39;",
    "   leading and trailing space   ",
    "runs   of \t\n whitespace\r\n\n inside",
    "cafÃ© mojibake and â€œsmart quotesâ€\u009d",
    "&nbsp;non-breaking&nbsp;space&#160;",
    "",
    " \t\n ",
]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_prompt_clean_matches_jax(prompt):
    assert torch_pipeline.prompt_clean(prompt) == jax_pipeline.prompt_clean(prompt)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_prompt_clean_calls_ftfy_like_jax(prompt, monkeypatch):
    calls = []

    def fix_text(text):
        calls.append(text)
        return "<fixed> " + text.replace("Ã©", "é")

    stub = types.ModuleType("ftfy")
    stub.fix_text = fix_text
    monkeypatch.setitem(sys.modules, "ftfy", stub)
    got = torch_pipeline.prompt_clean(prompt)
    assert calls == [prompt]
    want = jax_pipeline.prompt_clean(prompt)
    assert calls == [prompt, prompt]
    assert got == want
    assert got.startswith("<fixed>")      # the stub's change shows: ftfy ran first
