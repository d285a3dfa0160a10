"""The port's OpenAI frontend against the JAX package's, on the CPU.

- Preprocessor parity: ``PreprocessedRequest.to_dict()`` and the rendered
  prompt are equal for chat and completion requests with stop, max_tokens,
  temperature, seed, logprobs, penalties, min_tokens and the ext block;
  bodies the reference refuses (pydantic) the port refuses too.
- Backend parity: ``tests/test_llm_pipeline.py``'s stop-jail / EOS /
  max_tokens cases and logprob entries, step by step.
- HTTP parity: the reference ``run_http`` over ``JaxEngine`` against the
  port's ``run_http`` over ``TorchEngine``, both f32 with the same weights
  (``params_from_jax``) and the same model directory: streamed chat,
  streamed completion, non-streamed, ``n=2`` and a stop string give the same
  text, finish reasons and usage; bad bodies the same status and error
  type.
- A client that closes a stream mid-way frees the engine lane, and the
  server keeps serving.
- ``python -m dynamo_tpu_torch.run in=batch:FILE out=torch --device cpu``,
  and ``out=torch`` without a card refusing to fall back to the CPU.
"""

import asyncio
import http.client
import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from dynamo_tpu import backend as ref_backend
from dynamo_tpu import model_card as ref_card
from dynamo_tpu import preprocessor as ref_pre
from dynamo_tpu.entrypoint import inputs as ref_inputs
from dynamo_tpu.protocols import common as jp
from dynamo_tpu.protocols import openai as ref_openai
from dynamo_tpu.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch import backend as port_backend
from dynamo_tpu_torch import model_card as port_card
from dynamo_tpu_torch import preprocessor as port_pre
from dynamo_tpu_torch import run as port_run
from dynamo_tpu_torch.entrypoint import inputs as port_inputs
from dynamo_tpu_torch.protocols import common as tp
from dynamo_tpu_torch.protocols import openai as port_openai
from dynamo_tpu_torch.protocols.sse import SseParser
from tests.test_torch_engine import make_jax_engine, make_torch_engine
from tests.util import TEST_WORDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "tiny"
VOCAB = 128
WORDS = list(dict.fromkeys(TEST_WORDS)) + [f"w{i}" for i in range(VOCAB)]
WORDS = WORDS[: VOCAB - 3]
TEMPLATE = (
    "{{ bos_token }}{% for m in messages %}{{ m['role'] }} {{ m['content']|trim }}"
    "{% if not loop.last %} </s> {% endif %}{% endfor %}"
    "{% if add_generation_prompt %} assistant{% endif %}"
)
HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": VOCAB,
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "max_position_embeddings": 64,
    "tie_word_embeddings": False, "eos_token_id": 2, "bos_token_id": 1,
}


def write_model_dir(path, **config) -> str:
    """config.json (the tiny Llama), a WordLevel tokenizer.json whose 128
    ids all decode, and tokenizer_config.json with a chat template."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for w in WORDS:
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**HF_CONFIG, **config}, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": TEMPLATE, "bos_token": "<s>", "eos_token": "</s>"}, f)
    return str(path)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_model_dir(tmp_path_factory.mktemp("tiny_model"))


def cards(model_dir):
    return (ref_card.ModelDeploymentCard.from_model_dir(model_dir, MODEL),
            port_card.ModelDeploymentCard.from_model_dir(model_dir, MODEL))


# ------------------------------------------------------------ preprocessor

CHAT_BODIES = [
    {"messages": [{"role": "user", "content": "hello world"}]},
    {"messages": [{"role": "system", "content": " be brief "}, {"role": "user", "content": "the quick fox"},
                  {"role": "assistant", "content": "one two"}, {"role": "user", "content": "three STOP"}],
     "max_tokens": 7, "temperature": 0.3, "top_p": 0.9, "top_k": 5, "seed": 11, "stop": "STOP",
     "logprobs": True, "top_logprobs": 3, "frequency_penalty": 0.5, "presence_penalty": -0.5,
     "repetition_penalty": 1.2, "min_tokens": 4, "n": 2, "user": "u1"},
    {"messages": [{"role": "user", "content": [{"type": "text", "text": "a b"}, {"type": "text", "text": " c"}]}],
     "max_completion_tokens": 9, "stop": ["a b", "fox"], "nvext": {"greedy": True, "ignore_eos": True,
                                                                  "annotations": ["formatted_prompt"],
                                                                  "priority": "bulk"}},
    {"messages": [{"role": "user", "content": "x", "name": "bob", "extra_field": 1}], "ext": {"priority": 2},
     "stream": True, "stream_options": {"include_usage": True}, "logprobs": False},
]
COMPLETION_BODIES = [
    {"prompt": "hello world the quick"},
    {"prompt": ["one two", "ignored"], "max_tokens": 5, "logprobs": 2, "echo": True, "stop": ["two"],
     "temperature": 1.5, "seed": 3, "min_tokens": 1},
    {"prompt": [5, 6, 7], "max_tokens": None, "nvext": {"greedy": True}},
    {"prompt": [[5, 6], [7]], "top_logprobs": 0},
]
BAD_BODIES = [
    {}, [], "str", {"messages": []}, {"model": MODEL},
    {"model": 3, "messages": []},
    {"model": MODEL, "messages": [{"content": "no role"}]},
    {"model": MODEL, "messages": "hi"},
    {"model": MODEL, "messages": [], "temperature": 2.5},
    {"model": MODEL, "messages": [], "temperature": "hot"},
    {"model": MODEL, "messages": [], "top_p": 0},
    {"model": MODEL, "messages": [], "n": 0},
    {"model": MODEL, "messages": [], "n": 17},
    {"model": MODEL, "messages": [], "max_tokens": 0},
    {"model": MODEL, "messages": [], "top_logprobs": 21},
    {"model": MODEL, "messages": [], "stop": [1]},
    {"model": MODEL, "messages": [], "ext": {"timeout_ms": 0}},
    {"model": MODEL, "messages": [], "nvext": {"annotations": "x"}},
    {"model": MODEL, "messages": [], "frequency_penalty": -3},
    {"model": MODEL, "messages": [], "repetition_penalty": 0},
    {"model": MODEL, "messages": [], "min_tokens": -1},
    {"model": MODEL, "messages": [], "seed": 1.5},
    {"model": MODEL, "messages": [], "stream_options": "yes"},
    {"model": MODEL, "messages": [{"role": "user", "content": 5}]},
]
BAD_COMPLETIONS = [
    {"model": MODEL}, {"model": MODEL, "prompt": 5}, {"model": MODEL, "prompt": [1, "a"]},
    {"model": MODEL, "prompt": "x", "max_tokens": 0}, {"model": MODEL, "prompt": "x", "echo": "maybe"},
]


def test_preprocessor_parity_chat_and_completion(model_dir):
    ref_mdc, port_mdc = cards(model_dir)
    rp, pp = ref_pre.OpenAIPreprocessor(ref_mdc), port_pre.OpenAIPreprocessor(port_mdc)
    for body in CHAT_BODIES:
        body = {"model": MODEL, **body}
        a, ap = rp.preprocess_chat(ref_openai.ChatCompletionRequest.model_validate(body))
        b, bp = pp.preprocess_chat(port_openai.ChatCompletionRequest.from_dict(body))
        assert (b.to_dict(), bp) == (a.to_dict(), ap)
        assert [x.to_wire() for x in pp.requested_annotations(b, bp)] == [
            x.to_wire() for x in rp.requested_annotations(a, ap)]
    for body in COMPLETION_BODIES:
        body = {"model": MODEL, **body}
        a, ap = rp.preprocess_completion(ref_openai.CompletionRequest.model_validate(body))
        b, bp = pp.preprocess_completion(port_openai.CompletionRequest.from_dict(body))
        assert (b.to_dict(), bp) == (a.to_dict(), ap)


@pytest.mark.parametrize("kind", ["chat", "completion"])
def test_request_validation_refuses_what_pydantic_refuses(kind):
    ref_cls = ref_openai.ChatCompletionRequest if kind == "chat" else ref_openai.CompletionRequest
    port_cls = port_openai.ChatCompletionRequest if kind == "chat" else port_openai.CompletionRequest
    bodies = BAD_BODIES if kind == "chat" else BAD_COMPLETIONS
    for body in bodies:
        with pytest.raises(Exception):
            ref_cls.model_validate(body)
        with pytest.raises(port_openai.RequestValidationError):
            port_cls.from_dict(body)


# ----------------------------------------------------------------- backend


def backend_cases(mod):
    C = mod.StopConditions
    return [
        (C(stop=["lazy dog"]), [2], "hello world lazy dog quick", None),
        (C(stop=["dog", "fox jumps"]), [2], "the quick brown fox jumps over", None),
        (C(stop=["lazy"]), [2], "lazy", None),
        (C(max_tokens=100), [2], None, [3, 4, 2, 5]),
        (C(max_tokens=2), [2], None, [3, 4, 5]),
        (C(max_tokens=10, ignore_eos=True), [2], None, [3, 2, 4]),
        (C(max_tokens=10, stop_token_ids_hidden=[5]), [2], None, [3, 4, 5, 6]),
    ]


def test_backend_parity_on_pipeline_cases(model_dir):
    ref_mdc, port_mdc = cards(model_dir)
    ref_tok, port_tok = ref_mdc.load_tokenizer(), port_mdc.load_tokenizer()
    for (rs, eos, text, ids), (ps, _, _, _) in zip(backend_cases(jp), backend_cases(tp)):
        rdec = ref_backend.Backend(ref_tok).decoder(rs, eos)
        pdec = port_backend.Backend(port_tok).decoder(ps, eos)
        if ids is None:
            frames = [[t] for t in ref_tok.encode(text).ids]
        else:
            frames = [ids]
        for k, frame in enumerate(frames):
            lp = [-0.5 - j for j in range(len(frame))]
            top = [[[frame[j], -0.5], [7, -1.25]] for j in range(len(frame))]
            a = rdec.step(jp.LLMEngineOutput(token_ids=frame, log_probs=lp, top_logprobs=top))
            b = pdec.step(tp.LLMEngineOutput(token_ids=frame, log_probs=lp, top_logprobs=top))
            assert (b.text, b.tokens_emitted, b.logprobs) == (a.text, a.tokens_emitted, a.logprobs)
            assert (b.finish_reason and b.finish_reason.value) == (a.finish_reason and a.finish_reason.value)
        assert pdec.emitted_tokens == rdec.emitted_tokens


# -------------------------------------------------------------------- HTTP


def fetch(port, method, path, body=None, headers=None, timeout=60.0):
    """One request on its own connection: (status, headers, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


async def afetch(*args, **kw):
    return await asyncio.to_thread(fetch, *args, **kw)


def sse(data: bytes) -> list:
    events = SseParser().feed(data.decode())
    assert events and events[-1].is_done(), data[-200:]
    return events[:-1]


def summarize(status, body: bytes, stream: bool) -> dict:
    """Per choice: the text and finish reason; plus the usage (ids and
    timestamps differ between runs and are left out)."""
    if status != 200:
        return {"status": status, "type": json.loads(body)["error"]["type"]}
    if stream:
        chunks = [e.json() for e in sse(body) if e.event is None]
    else:
        chunks = [json.loads(body)]
    out: dict = {"status": status, "usage": None, "choices": {}}
    for c in chunks:
        if c.get("usage"):
            out["usage"] = c["usage"]
        for ch in c.get("choices", []):
            slot = out["choices"].setdefault(ch["index"], {"text": "", "finish": None})
            piece = (ch.get("delta") or {}).get("content") or ch.get("text") or (
                (ch.get("message") or {}).get("content")) or ""
            slot["text"] += piece
            slot["finish"] = ch.get("finish_reason") or slot["finish"]
    return out


USAGE = {"stream_options": {"include_usage": True}}
GREEDY = {"temperature": 0.0}
HTTP_CASES = [
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello world the quick"}],
                              "max_tokens": 12, "stream": True, **GREEDY, **USAGE}),
    ("/v1/completions", {"prompt": "one two three four", "max_tokens": 10, "stream": True, **GREEDY, **USAGE}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "lazy dog jumps"}],
                              "max_tokens": 9, "stream": False, **GREEDY, **USAGE}),
    ("/v1/completions", {"prompt": "brown fox", "max_tokens": 6, "stream": False, "echo": True, **GREEDY}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "a b c d"}], "n": 2,
                              "max_tokens": 8, "stream": True, **GREEDY, **USAGE}),
    ("/v1/completions", {"prompt": "e f g", "n": 2, "max_tokens": 7, "stream": False, **GREEDY, **USAGE}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "six five four"}],
                              "max_tokens": 10, "stream": True, "min_tokens": 3, "frequency_penalty": 0.8,
                              "repetition_penalty": 1.3, **GREEDY, **USAGE}),
]
BAD_HTTP = [
    ("/v1/chat/completions", b"{not json"),
    ("/v1/chat/completions", {"model": MODEL}),
    ("/v1/chat/completions", {"model": "nope", "messages": []}),
    ("/v1/chat/completions", {"model": MODEL, "messages": [], "n": 0}),
    ("/v1/completions", {"model": MODEL}),
    ("/v1/completions", {"model": MODEL, "prompt": "x", "temperature": -1}),
    ("/v1/chat/completions", {"model": MODEL, "messages": [
        {"role": "user", "content": [{"type": "image_url", "image_url": {"url": "http://x/y.png"}}]}]}),
]


async def serve_pair(model_dir):
    """The reference's frontend over JaxEngine and the port's over
    TorchEngine (same weights, f32, same model directory)."""
    ref_mdc, port_mdc = cards(model_dir)
    drt = await DistributedRuntime.detached()
    jeng, teng = make_jax_engine(), make_torch_engine()
    ref_svc = await ref_inputs.run_http(drt, ref_inputs.EngineConfig.static_(jeng, ref_mdc),
                                        host="127.0.0.1", port=0)
    port_svc = await port_inputs.run_http(port_inputs.EngineConfig.static_(teng, port_mdc),
                                          host="127.0.0.1", port=0)

    async def close():
        await port_svc.close()
        await ref_svc.close()
        await jeng.close()
        await teng.close()
        await drt.close()
    return ref_svc.port, port_svc.port, teng, close


async def both(ref_port, port_port, path, body, **kw):
    a = await afetch(ref_port, "POST", path, body, **kw)
    b = await afetch(port_port, "POST", path, body, **kw)
    return a, b


@pytest.mark.timeout(300)
async def test_http_parity_with_the_jax_frontend(model_dir):
    ref_port, port_port, teng, close = await serve_pair(model_dir)
    try:
        for path, body in HTTP_CASES:
            body = {"model": MODEL, **body}
            a, b = await both(ref_port, port_port, path, body)
            sa, sb = summarize(a[0], a[2], body["stream"]), summarize(b[0], b[2], body["stream"])
            assert sb == sa, (path, body)
            assert sa["status"] == 200 and all(c["finish"] for c in sa["choices"].values())
        # a stop string taken from the middle of the greedy text
        path, body = HTTP_CASES[0]
        body = {"model": MODEL, **body}
        text = summarize(*(await afetch(port_port, "POST", path, body))[::2], True)["choices"][0]["text"]
        stop = text.split()[3]
        a, b = await both(ref_port, port_port, path, {**body, "stop": [stop]})
        sa, sb = summarize(a[0], a[2], True), summarize(b[0], b[2], True)
        assert sb == sa and sa["choices"][0]["finish"] == "stop" and stop not in sa["choices"][0]["text"]
        # bad bodies: the same status and error type
        for path, body in BAD_HTTP:
            a, b = await both(ref_port, port_port, path, body)
            assert (b[0], json.loads(b[2])["error"]["type"]) == (a[0], json.loads(a[2])["error"]["type"]), body
        # listings, health, the sanitized request id
        for path in ("/v1/models", "/health"):
            ra, rb = await afetch(ref_port, "GET", path), await afetch(port_port, "GET", path)
            da, db = json.loads(ra[2]), json.loads(rb[2])
            for d in (da, db):
                for m in d.get("data", []):
                    m.pop("created")
            assert (rb[0], db) == (ra[0], da)
        path, body = HTTP_CASES[2]
        a, b = await both(ref_port, port_port, path, {"model": MODEL, **body},
                          headers={"x-request-id": " my id/?"})
        assert a[1]["x-request-id"] == b[1]["x-request-id"] == "my-id--"
        # an engine error: a prompt past max_model_len, streamed and not
        for stream in (False, True):
            too_long = {"model": MODEL, "prompt": [5] * 70, "max_tokens": 4, "stream": stream}
            a, b = await both(ref_port, port_port, "/v1/completions", too_long)
            if stream:
                ea = [e for e in sse(a[2]) if e.event == "error"]
                eb = [e for e in sse(b[2]) if e.event == "error"]
                assert len(ea) == len(eb) == 1
                assert eb[0].json()["error"]["type"] == ea[0].json()["error"]["type"] == "prompt_too_long"
            else:
                assert (b[0], json.loads(b[2])["error"]["type"]) == (a[0], json.loads(a[2])["error"]["type"])
        st, _, body = await afetch(port_port, "GET", "/v1/nothing")
        assert st == 404 and json.loads(body)["error"]["type"] == "not_found_error"
        assert teng.allocator.free_count == teng.config.num_blocks - 1
    finally:
        await close()


def read_then_hang_up(port, body, events: int) -> list:
    """Stream a request, read ``events`` SSE events, then close the socket."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                  headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    got = []
    while len(got) < events:
        line = resp.fp.readline()
        if line.startswith(b"data:"):
            got.append(line)
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    return got


@pytest.mark.timeout(300)
async def test_client_disconnect_mid_stream_frees_the_lane(model_dir):
    port_mdc = port_card.ModelDeploymentCard.from_model_dir(model_dir, MODEL, context_length=512)
    from dynamo_tpu_torch.engine.torch_engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.engine.torch_engine.model_runner import TorchModelRunner

    base = make_torch_engine()
    runner = TorchModelRunner(base.runner.config, base.runner.params, num_blocks=160, block_size=4,
                              max_batch=2, max_model_len=512, device="cpu", prefill_chunk_tokens=0)
    eng = TorchEngine(runner, TorchEngineConfig(max_batch=2, block_size=4, num_blocks=160, max_model_len=512))
    config = port_inputs.EngineConfig.static_(eng, port_mdc)
    svc = await port_inputs.run_http(config, host="127.0.0.1", port=0)
    try:
        body = {"model": MODEL, "messages": [{"role": "user", "content": "hello"}], "max_tokens": 400,
                "stream": True, "nvext": {"ignore_eos": True}, **GREEDY}
        got = await asyncio.to_thread(read_then_hang_up, svc.port, body, 4)
        assert len(got) == 4
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                eng.allocator.free_count == 159 and all(s is None for s in eng.slots)):
            await asyncio.sleep(0.02)
        # freed long before the 400 tokens the request asked for
        assert eng.allocator.free_count == 159 and all(s is None for s in eng.slots)
        assert eng.stats.generated_tokens < 400
        # the server keeps serving
        st, _, data = await afetch(svc.port, "POST", "/v1/chat/completions",
                                   {**body, "max_tokens": 5, "stream": False})
        assert st == 200 and json.loads(data)["choices"][0]["finish_reason"] == "length"
    finally:
        await svc.close()
        await eng.close()


class StubEngine:
    """Streams the prompt's ids back, one per frame, up to max_tokens; with
    ``fail_at`` it raises at that token (an engine bug)."""

    def __init__(self, fail_at=None) -> None:
        self.fail_at = fail_at

    async def generate(self, req, ctx):
        for i in range(req.stop.max_tokens):
            if ctx.is_stopped():
                yield tp.LLMEngineOutput.final(tp.FinishReason.CANCELLED)
                return
            if i == self.fail_at:
                raise RuntimeError("stub engine failure")
            await asyncio.sleep(0)
            yield tp.LLMEngineOutput(token_ids=[req.token_ids[i % len(req.token_ids)]])
        yield tp.LLMEngineOutput.final(tp.FinishReason.LENGTH)


async def raw_exchange(port: int, data: bytes, then: bytes = b"") -> bytes:
    """Write ``data`` on a fresh socket (and ``then`` once the server has
    answered something), read until the server closes."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(data)
        await writer.drain()
        out = b""
        if then:
            out += await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 30)
            writer.write(then)
            await writer.drain()
        return out + await asyncio.wait_for(reader.read(), 30)
    finally:
        writer.close()


@pytest.mark.timeout(120)
async def test_http_server_protocol_edges(model_dir):
    port_mdc = port_card.ModelDeploymentCard.from_model_dir(model_dir, MODEL)
    svc = await port_inputs.run_http(port_inputs.EngineConfig.static_(StubEngine(), port_mdc),
                                     host="127.0.0.1", port=0)
    bad = await port_inputs.run_http(port_inputs.EngineConfig.static_(StubEngine(fail_at=2), port_mdc),
                                     host="127.0.0.1", port=0)
    try:
        body = {"model": MODEL, "prompt": "hello world the quick", "max_tokens": 6, "stream": True}

        def keep_alive():
            conn = http.client.HTTPConnection("127.0.0.1", svc.port, timeout=30)
            try:
                socks, out = [], []
                for b in (body, {**body, "stream": False}, None):
                    if b is None:
                        conn.request("GET", "/health")
                    else:
                        conn.request("POST", "/v1/completions", body=json.dumps(b),
                                     headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    out.append((resp.status, resp.getheader("Connection"), resp.read()))
                    socks.append(conn.sock)
                return socks, out
            finally:
                conn.close()

        socks, out = await asyncio.to_thread(keep_alive)
        assert [o[0] for o in out] == [200, 200, 200] and len({id(x) for x in socks}) == 1
        assert summarize(200, out[0][2], True)["choices"][0] == summarize(200, out[1][2], False)["choices"][0]
        # Expect: 100-continue, then the body
        payload = json.dumps({**body, "stream": False}).encode()
        head = (b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                b"Connection: close\r\nExpect: 100-continue\r\nContent-Length: %d\r\n\r\n" % len(payload))
        got = await raw_exchange(svc.port, head, then=payload)
        assert got.startswith(b"HTTP/1.1 100 Continue\r\n\r\nHTTP/1.1 200 OK\r\n")
        assert json.loads(got.split(b"\r\n\r\n", 2)[2])["choices"][0]["finish_reason"] == "length"
        # malformed requests: each answered, then the connection closes
        for data, status in (
                (b"NONSENSE\r\n\r\n", 400),
                (b"POST /v1/completions HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n", 411),
                (b"POST /v1/completions HTTP/1.1\r\nContent-Length: 999999999999\r\n\r\n", 413),
                (b"POST /v1/completions HTTP/1.1\r\nContent-Length: x\r\n\r\n", 400),
                (b"GET /v1/completions HTTP/1.1\r\nConnection: close\r\n\r\n", 405),
                (b"GET /nope HTTP/1.1\r\nConnection: close\r\n\r\n", 404)):
            got = await raw_exchange(svc.port, data)
            assert got.startswith(b"HTTP/1.1 %d " % status), (data, got[:80])
            assert "error" in json.loads(got.split(b"\r\n\r\n", 1)[1])
        # an engine that raises: a typed SSE error then [DONE]; 500 unary
        st, _, data = await afetch(bad.port, "POST", "/v1/completions", body)
        events = sse(data)
        assert st == 200 and events[-1].event == "error"
        assert events[-1].json()["error"]["type"] == "internal_error"
        st, _, data = await afetch(bad.port, "POST", "/v1/completions", {**body, "stream": False})
        assert st == 500 and json.loads(data)["error"]["type"] == "internal_error"
        # --request-template defaults fill what the body leaves out
        from dynamo_tpu_torch.request_template import RequestTemplate

        tpl_path = os.path.join(model_dir, "request_template.json")
        with open(tpl_path, "w") as f:
            json.dump({"model": MODEL, "temperature": 0.5, "max_completion_tokens": 3}, f)
        svc.template = RequestTemplate.load(tpl_path)
        st, _, data = await afetch(svc.port, "POST", "/v1/chat/completions",
                                   {"messages": [{"role": "user", "content": "one two"}]})
        assert st == 200 and json.loads(data)["model"] == MODEL
        svc.template = None
        # a template's raise_exception is the request's fault: 400
        strict = port_card.ModelDeploymentCard.from_model_dir(model_dir, "strict")
        strict.chat_template = "{{ raise_exception('no') }}"
        svc.manager.add_model("strict", port_inputs.EngineConfig.static_(StubEngine(), strict).execution())
        for stream in (True, False):
            st, _, data = await afetch(svc.port, "POST", "/v1/chat/completions", {
                "model": "strict", "messages": [{"role": "user", "content": "x"}], "stream": stream})
            assert st == 400 and json.loads(data)["error"]["type"] == "invalid_request_error"
    finally:
        await svc.close()
        await bad.close()


# --------------------------------------------------------------------- CLI


def test_run_batch_mode_on_the_cpu(tmp_path):
    model_dir = write_model_dir(tmp_path / "model")
    batch = tmp_path / "batch.jsonl"
    batch.write_text("\n".join(json.dumps(r) for r in (
        {"text": "hello world", "max_tokens": 6}, {"prompt": "the quick brown fox", "max_tokens": 4})) + "\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.run", f"in=batch:{batch}", "out=torch",
         "--model-path", model_dir, "--device", "cpu", "--context-length", "64",
         "--num-blocks", "64", "--max-batch", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [json.loads(line) for line in (tmp_path / "batch.jsonl.out.jsonl").read_text().splitlines()]
    assert len(rows) == 2
    for row in rows:
        assert row["text"] and row["ttft_ms"] is not None and row["elapsed_ms"] > 0


def test_run_text_mode_on_the_cpu(tmp_path):
    model_dir = write_model_dir(tmp_path / "model")
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.run", "in=text", "out=torch", "--model-path", model_dir,
         "--model-name", "tiny-chat", "--device", "cpu", "--context-length", "64", "--num-blocks", "64"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), input="hello world\n", capture_output=True,
        text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("chatting with tiny-chat") and lines[1].strip()


def test_out_torch_without_a_card_raises_instead_of_running_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    # head_dim 64, which the card's kernels take, so the refusal is the card's
    model_dir = write_model_dir(tmp_path / "model", hidden_size=128, num_attention_heads=2,
                                num_key_value_heads=1, head_dim=64)
    args = port_run.parse_args(["in=http", "out=torch", "--model-path", model_dir])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        port_run.build_config(args)
