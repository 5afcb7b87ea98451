"""LLM video-QA evaluation harness.

Port of ``videocad_tpu/qa/harness.py`` (standard library only), a host-side
re-design of the reference eval_qa.py: a multiple-choice VQA
benchmark where an LLM picks an option ID given a question, associated
images (base64-inlined), and options. Capabilities preserved:

  * provider routing by model-name prefix (OpenAI- and Anthropic-style REST
    APIs via urllib — no SDK dependency), plus built-in ``mock`` (always the
    first option) and ``random`` backends for keyless runs;
  * strict "answer with the option ID only" system prompt with fuzzy ID
    recovery and random fallback (eval_qa.py:263-307);
  * a resumable pipeline with periodic saves and per-template accuracy
    (eval_qa.py:401-547).

Fixes over the reference: the undefined ``INVALID_GROUPS`` on the
resume/skip path (quirk 10) becomes an explicit optional ``skip_ids``
filter.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import random
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

UNKNOWN_ANSWER_CODE = "unknown_answer_code"

SYSTEM_PROMPT = (
    "You are an expert VQA assistant. Given a question, associated images, "
    "and a list of options (some of which may be images), your task is to "
    "choose the best option and respond with its ID only. Do not provide "
    "any explanation or any other text. Your answer must be one of the "
    "provided option IDs."
)


# --------------------------------------------------------------------------
# Schemas (plain dataclasses; validated in from_dict)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Option:
    id: str
    text: Optional[Union[str, int, float]] = None
    path: Optional[str] = None


@dataclasses.dataclass
class QAItem:
    id: int
    question_text: str
    image_refs: Dict[str, str]
    options: List[Option]
    answer: str
    template: str

    @staticmethod
    def from_dict(item: Dict[str, Any]) -> "QAItem":
        question = item["question"]
        return QAItem(
            id=int(item["id"]),
            question_text=str(question["text"]),
            image_refs=dict(question.get("image_refs") or {}),
            options=[Option(id=o["id"], text=o.get("text"), path=o.get("path"))
                     for o in item["options"]],
            answer=str(item["answer"]),
            template=str(item["template"]),
        )

    @property
    def option_ids(self) -> List[str]:
        return [o.id for o in self.options]


@dataclasses.dataclass
class ModelOutput:
    model: str
    answer: str
    question_id: int
    correct: int
    model_reasoning: Optional[str] = None

    def to_dict(self):
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------
# Dataset
# --------------------------------------------------------------------------

class QADataset:
    def __init__(self, qa_dataset_path: str,
                 question_range: Optional[Tuple[int, int]] = None):
        with open(qa_dataset_path) as f:
            data = json.load(f)
        items = [QAItem.from_dict(d) for d in data]
        if question_range:
            items = items[question_range[0]:question_range[1]]
        self.items = items
        self.by_id = {item.id: item for item in items}

    def __len__(self):
        return len(self.items)

    def get(self, question_id: int) -> QAItem:
        return self.by_id[question_id]


# --------------------------------------------------------------------------
# Prompt assembly
# --------------------------------------------------------------------------

def _image_b64(path: str) -> str:
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode("utf-8")


def build_content(item: QAItem) -> List[Dict[str, Any]]:
    """OpenAI-style multimodal content blocks for one question."""
    text = re.sub(r"<[^>]+>", "", item.question_text)
    content: List[Dict[str, Any]] = [{"type": "text", "text": text}]
    for ref in item.image_refs.values():
        content.append({"type": "image_url", "image_url": {
            "url": f"data:image/png;base64,{_image_b64(ref)}",
            "detail": "high"}})
    for opt in item.options:
        content.append({"type": "text", "text": f"{opt.id}: "})
        if opt.text is not None:
            content.append({"type": "text", "text": str(opt.text)})
        if opt.path:
            content.append({"type": "image_url", "image_url": {
                "url": f"data:image/png;base64,{_image_b64(opt.path)}",
                "detail": "high"}})
    return content


def recover_answer_id(raw: str, valid_ids: Sequence[str],
                      rng: random.Random) -> str:
    """Strict-then-fuzzy option-ID extraction with random fallback."""
    answer = raw.strip().lower()
    if answer in valid_ids:
        return answer
    found = next((v for v in valid_ids if v in answer), None)
    return found if found is not None else rng.choice(list(valid_ids))


# --------------------------------------------------------------------------
# Provider clients
# --------------------------------------------------------------------------

class BaseClient:
    name = "base"

    def complete(self, item: QAItem) -> str:
        raise NotImplementedError


class MockClient(BaseClient):
    """Keyless backend: always the first option (pipeline plumbing tests)."""

    name = "mock"

    def complete(self, item: QAItem) -> str:
        return item.option_ids[0] if item.option_ids else "mock_response"


class RandomClient(BaseClient):
    """Keyless backend: a uniformly random option (chance baseline)."""

    name = "random"

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)

    def complete(self, item: QAItem) -> str:
        return self._rng.choice(item.option_ids)


class OpenAICompatClient(BaseClient):
    """Chat-completions REST client (OpenAI/Qwen/GLM/OpenRouter endpoints)."""

    def __init__(self, model: str, api_key: str, base_url: str, timeout=120):
        self.name = model
        self.model = model
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def complete(self, item: QAItem) -> str:
        import urllib.request
        payload = {
            "model": self.model,
            "messages": [
                {"role": "system", "content": SYSTEM_PROMPT},
                {"role": "user", "content": build_content(item)},
            ],
            "temperature": 0,
        }
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = json.loads(resp.read())
        return data["choices"][0]["message"]["content"]


class AnthropicClient(BaseClient):
    """Anthropic Messages REST client."""

    def __init__(self, model: str, api_key: str,
                 base_url: str = "https://api.anthropic.com/v1", timeout=120):
        self.name = model
        self.model = model
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    @staticmethod
    def _convert_content(blocks):
        out = []
        for b in blocks:
            if b["type"] == "text":
                out.append({"type": "text", "text": b["text"]})
            else:
                b64 = b["image_url"]["url"].split(",", 1)[1]
                out.append({"type": "image", "source": {
                    "type": "base64", "media_type": "image/png",
                    "data": b64}})
        return out

    def complete(self, item: QAItem) -> str:
        import urllib.request
        payload = {
            "model": self.model,
            "max_tokens": 64,
            "system": SYSTEM_PROMPT,
            "messages": [{"role": "user",
                          "content": self._convert_content(build_content(item))}],
            "temperature": 0,
        }
        req = urllib.request.Request(
            f"{self.base_url}/messages",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     "x-api-key": self.api_key,
                     "anthropic-version": "2023-06-01"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = json.loads(resp.read())
        return data["content"][0]["text"]


# Prefix -> (provider, env var, endpoint) routing (eval_qa.py:69-92)
PROVIDER_ROUTES = (
    (("gpt", "o3", "openai"), "openai", "OPENAI_API_KEY",
     "https://api.openai.com/v1"),
    (("claude", "anthropic"), "anthropic", "ANTHROPIC_API_KEY", None),
    (("gemini", "google"), "google", "GOOGLE_API_KEY",
     "https://generativelanguage.googleapis.com/v1beta/openai"),
    (("qwen",), "qwen", "QWEN_API_KEY",
     "https://dashscope-intl.aliyuncs.com/compatible-mode/v1"),
    (("glm",), "glm", "GLM_API_KEY",
     "https://open.bigmodel.cn/api/paas/v4"),
    (("internvl", "opengvlab"), "openrouter", "OPEN_ROUTER_KEY",
     "https://openrouter.ai/api/v1"),
)


def create_client(model_name: str, api_key: Optional[str] = None,
                  mock_mode: bool = False, seed: Optional[int] = None
                  ) -> BaseClient:
    if mock_mode:
        return MockClient()
    if model_name.startswith("random"):
        return RandomClient(seed)
    lowered = model_name.lower()
    for prefixes, provider, env_var, base_url in PROVIDER_ROUTES:
        if any(lowered.startswith(p) for p in prefixes):
            key = api_key or os.getenv(env_var)
            if not key:
                raise ValueError(f"{env_var} not set for provider {provider}")
            if provider == "anthropic":
                return AnthropicClient(model_name, key)
            return OpenAICompatClient(model_name, key, base_url)
    raise ValueError(f"Unsupported model: {model_name}")


# --------------------------------------------------------------------------
# Metrics + pipeline
# --------------------------------------------------------------------------

def template_accuracies(outputs: List[Dict], dataset: QADataset) -> Dict:
    """Per-template + overall accuracy (eval_qa.py:499-540 schema)."""
    correct: Dict[str, int] = {}
    total: Dict[str, int] = {}
    num_correct = 0
    for out in outputs:
        item = dataset.by_id.get(out["question_id"])
        if item is None:
            continue
        total[item.template] = total.get(item.template, 0) + 1
        if out["correct"] == 1:
            correct[item.template] = correct.get(item.template, 0) + 1
            num_correct += 1
    result: Dict[str, Any] = {}
    for template, n in total.items():
        c = correct.get(template, 0)
        result[template] = c / n * 100 if n else 0.0
        result[f"{template}_total"] = n
        result[f"{template}_correct"] = c
    n_all = len(outputs)
    result["overall_accuracy"] = num_correct / n_all * 100 if n_all else 0.0
    result["num_questions"] = n_all
    result["num_correct"] = num_correct
    return result


class EvaluationPipeline:
    """Resumable question loop with periodic result/metric saves."""

    def __init__(self, dataset: QADataset, output_dir: str,
                 client: BaseClient, question_range_str: Optional[str] = None,
                 save_freq: int = 10, skip_ids: Optional[set] = None,
                 seed: int = 0):
        self.dataset = dataset
        self.client = client
        self.save_freq = save_freq
        self.skip_ids = skip_ids or set()
        self._rng = random.Random(seed)
        suffix = f"_{question_range_str}" if question_range_str else "_all"
        self.results_dir = Path(output_dir) / client.name
        self.results_dir.mkdir(parents=True, exist_ok=True)
        self.results_path = self.results_dir / f"model_results{suffix}.json"
        self.answers_path = self.results_dir / f"model_answers{suffix}.json"
        self.outputs: List[Dict] = []
        self._load_existing()

    def _load_existing(self):
        if not self.results_path.exists():
            return
        try:
            with open(self.results_path) as f:
                existing = json.load(f)
            self.outputs = [o for o in existing
                            if o.get("answer") != UNKNOWN_ANSWER_CODE]
            print(f"Loaded {len(self.outputs)} existing results.")
        except (json.JSONDecodeError, OSError) as e:
            print(f"Could not load existing results: {e}")
            self.outputs = []

    def _save(self):
        with open(self.results_path, "w") as f:
            json.dump(self.outputs, f, indent=4)
        with open(self.answers_path, "w") as f:
            json.dump(template_accuracies(self.outputs, self.dataset), f,
                      indent=4)

    def _record(self, item: QAItem, answer_id: str):
        if answer_id != UNKNOWN_ANSWER_CODE and answer_id not in item.option_ids:
            answer_id = self._rng.choice(item.option_ids)
        output = ModelOutput(
            model=self.client.name, answer=answer_id, question_id=item.id,
            correct=int(answer_id == item.answer))
        self.outputs.append(output.to_dict())

    def run(self):
        processed = {o["question_id"] for o in self.outputs
                     if o.get("answer") != UNKNOWN_ANSWER_CODE}
        for i, item in enumerate(self.dataset.items):
            if item.id in processed or item.id in self.skip_ids:
                continue
            try:
                raw = self.client.complete(item)
                answer = recover_answer_id(raw, item.option_ids, self._rng)
            except Exception as e:  # network/provider error: mark unknown
                print(f"Error on question {item.id}: {e}")
                answer = UNKNOWN_ANSWER_CODE
            self._record(item, answer)
            if (i + 1) % self.save_freq == 0:
                self._save()
        self._save()
        return template_accuracies(self.outputs, self.dataset)
