"""Tool calling and ``/v1/responses`` in the port against the JAX package's,
on the CPU.

- ``tool_calling.parse_tool_calls``: the port returns the calls the
  reference returns (names and arguments; ids are random in both) over the
  reference's test strings (Hermes, Mistral, Llama-3 JSON, plain text,
  malformed) and a ``hypothesis`` sweep of calls in each format wrapped in
  arbitrary text.
- Over HTTP (the twin of ``tests/test_tools_and_embeddings.py::
  test_tool_calls_lifted_over_http``): a chat request that declares tools
  gets the echoed Hermes call lifted into ``tool_calls`` with the
  ``tool_calls`` finish, unary and streamed, and without tools the text
  comes back as text. ``/v1/responses`` answers a text input as a Response
  object whose text is the chat answer, and refuses items input and tools
  with 501.
"""

import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu import tool_calling as jtc
from dynamo_tpu_torch import tool_calling as ttc
from dynamo_tpu_torch.engine.echo import EchoEngineFull
from dynamo_tpu_torch.entrypoint.inputs import EngineConfig, run_http
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from tests.test_torch_engine import make_torch_engine
from tests.test_torch_frontend import MODEL, afetch, model_dir, sse  # noqa: F401


def calls(mod, text, **kw):
    out = mod.parse_tool_calls(text, **kw)
    return None if out is None else [(c.name, c.arguments) for c in out]


REFERENCE_STRINGS = [
    'thinking...\n<tool_call>\n{"name": "get_weather", "arguments": {"city": "Paris", "unit": "C"}}\n</tool_call>',
    '<tool_call>{"name": "a", "arguments": {}}</tool_call><tool_call>{"name": "b", "arguments": {"x": 1}}</tool_call>',
    '[TOOL_CALLS] [{"name": "search", "arguments": {"q": "tpu"}}]',
    '{"name": "lookup", "parameters": {"key": "v5e"}}',
    '<|python_tag|>{"name": "lookup", "parameters": {"key": "v5e"}}',
    "the weather is nice today",
    '{"not_a_call": 1}',
    "<tool_call>not json</tool_call>",
    '[TOOL_CALLS] {"name": "one", "arguments": "{\\"a\\": 2}"}',
    '{"name": "x", "arguments": "not json"}',
    '[{"name": "p", "parameters": {}}, {"name": "q", "parameters": {"z": [1, 2]}}]',
    "",
]


@pytest.mark.parametrize("text", REFERENCE_STRINGS)
@pytest.mark.parametrize("parser", [None, "hermes", "mistral", "llama3_json"])
def test_parsers_return_the_reference_calls(text, parser):
    kw = {} if parser is None else {"parser": parser}
    assert calls(ttc, text, **kw) == calls(jtc, text, **kw)


def test_parser_cases_and_openai_shape():
    got = ttc.parse_tool_calls(REFERENCE_STRINGS[0])
    assert [(c.name, c.arguments) for c in got] == [("get_weather", {"city": "Paris", "unit": "C"})]
    oc = got[0].to_openai(0)
    assert oc["type"] == "function" and json.loads(oc["function"]["arguments"]) == got[0].arguments
    assert set(oc) == set(jtc.parse_tool_calls(REFERENCE_STRINGS[0])[0].to_openai(0))
    with pytest.raises(ValueError):
        ttc.parse_tool_calls("x", parser="nope")


_json_scalars = st.one_of(st.integers(-5, 5), st.text(max_size=6), st.booleans(), st.none())
_args = st.dictionaries(st.text(min_size=1, max_size=6), _json_scalars, max_size=3)
_names = st.text(alphabet="abcdefghij_", min_size=1, max_size=8)
_noise = st.text(alphabet=st.characters(blacklist_categories=("Cs",)), max_size=20)


@settings(max_examples=150, deadline=None)
@given(name=_names, args=_args, pre=_noise, post=_noise,
       fmt=st.sampled_from(["hermes", "mistral", "llama3", "llama3_params", "raw"]))
def test_parsers_agree_on_generated_calls(name, args, pre, post, fmt):
    call = json.dumps({"name": name, "arguments": args})
    text = {
        "hermes": f"{pre}<tool_call>{call}</tool_call>{post}",
        "mistral": f"{pre}[TOOL_CALLS] [{call}]",
        "llama3": call,
        "llama3_params": json.dumps({"name": name, "parameters": args}),
        "raw": f"{pre}{call}{post}",
    }[fmt]
    assert calls(ttc, text) == calls(jtc, text)


# -------------------------------------------------------------------- HTTP


async def _service(model_dir, engine):
    mdc = ModelDeploymentCard.from_model_dir(model_dir, MODEL)
    return await run_http(EngineConfig.static_(engine, mdc), host="127.0.0.1", port=0)


async def test_tool_calls_lifted_over_http(model_dir, monkeypatch):
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "0")
    svc = await _service(model_dir, EchoEngineFull())
    call_text = '<tool_call> {"name": "get_weather", "arguments": {"city": "SF"}} </tool_call>'
    try:
        payload = {"model": MODEL, "messages": [{"role": "user", "content": call_text}],
                   "stream": False, "max_tokens": 32,
                   "tools": [{"type": "function", "function": {"name": "get_weather", "parameters": {}}}]}
        st_, _, body = await afetch(svc.port, "POST", "/v1/chat/completions", payload)
        assert st_ == 200, body
        choice = json.loads(body)["choices"][0]
        assert choice["finish_reason"] == "tool_calls"
        tc = choice["message"]["tool_calls"]
        assert tc[0]["function"]["name"] == "get_weather"
        assert json.loads(tc[0]["function"]["arguments"]) == {"city": "SF"}
        assert not choice["message"].get("content")
        del payload["tools"]
        _, _, body = await afetch(svc.port, "POST", "/v1/chat/completions", payload)
        c2 = json.loads(body)["choices"][0]
        assert c2["finish_reason"] in ("stop", "length") and not c2["message"].get("tool_calls")
        assert "get_weather" in c2["message"]["content"]
        payload["tools"] = [{"type": "function", "function": {"name": "get_weather"}}]
        payload["stream"] = True
        _, _, raw = await afetch(svc.port, "POST", "/v1/chat/completions", payload)
        chunks = [e.json() for e in sse(raw) if e.event is None]
        assert any(c.get("choices") and c["choices"][0]["delta"].get("tool_calls") for c in chunks)
        assert "tool_calls" in [c["choices"][0].get("finish_reason") for c in chunks if c.get("choices")]
    finally:
        await svc.close()


async def test_responses_route_answers_a_response_object(model_dir):
    engine = make_torch_engine()
    svc = await _service(model_dir, engine)
    try:
        chat = {"model": MODEL, "messages": [{"role": "user", "content": "a b c"}],
                "max_completion_tokens": 4, "temperature": 0.0}
        _, _, body = await afetch(svc.port, "POST", "/v1/chat/completions", chat)
        want = json.loads(body)["choices"][0]["message"]["content"]
        st_, hdrs, body = await afetch(svc.port, "POST", "/v1/responses",
                                       {"model": MODEL, "input": "a b c", "max_output_tokens": 4,
                                        "temperature": 0.0}, headers={"x-request-id": "resp-1"})
        assert st_ == 200 and hdrs["x-request-id"] == "resp-1"
        doc = json.loads(body)
        assert doc["object"] == "response" and doc["status"] == "completed" and doc["model"] == MODEL
        out = doc["output"][0]
        assert out["type"] == "message" and out["role"] == "assistant"
        assert out["content"][0]["type"] == "output_text" and out["content"][0]["text"] == want
        for bad in ({"input": [{"role": "user", "content": "x"}]}, {"input": "x", "tools": [{"a": 1}]},
                    {"input": "x", "previous_response_id": "r0"}):
            st_, _, body = await afetch(svc.port, "POST", "/v1/responses", {"model": MODEL, **bad})
            assert st_ == 501 and json.loads(body)["error"]["type"] == "not_implemented"
        st_, _, _ = await afetch(svc.port, "POST", "/v1/responses", {"model": "nope", "input": "x"})
        assert st_ == 404
    finally:
        await svc.close()
        await engine.close()
