"""The port's Jinja subset (``dynamo_tpu_torch.chat_template``, behind the
port's ``ChatTemplate``) against the reference ``ChatTemplate`` (jinja2
with trim_blocks / lstrip_blocks), on the default template, public-style
templates (Llama-3, Mistral, Gemma, Llama-3.1- and Qwen2.5-style templates
with tools) and
test-written templates that use every construct of the subset, with
hypothesis message lists. The output must be the identical text, or both
must raise; syntax outside the subset must raise at construction.
"""

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.tokenizer import DEFAULT_CHAT_TEMPLATE
from dynamo_tpu.tokenizer import ChatTemplate as RefTemplate
from dynamo_tpu_torch.chat_template import Template, TemplateSyntaxError, lex
from dynamo_tpu_torch.tokenizer import ChatTemplate as PortTemplate

LLAMA3 = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    "+ message['content'] | trim + '<|eot_id|>' %}{% if loop.index0 == 0 %}"
    "{% set content = bos_token + content %}{% endif %}{{ content }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}"
)

MISTRAL = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}"
    "{% endif %}{% if message['role'] == 'user' %}{{ '[INST] ' + message['content'] + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}{{ message['content'] + eos_token}}"
    "{% else %}{{ raise_exception('Only user and assistant roles are supported!') }}"
    "{% endif %}{% endfor %}"
)

QWEN_TOOLS = """{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0]['role'] == 'system' %}
        {{- messages[0]['content'] }}
    {%- else %}
        {{- 'You are a helpful assistant.' }}
    {%- endif %}
    {{- "\\n\\n# Tools\\n\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0]['role'] == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}
    {%- else %}
        {{- '<|im_start|>system\\nYou are a helpful assistant.<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant" and not message.tool_calls) %}
        {{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {{- '<|im_start|>' + message.role }}
        {%- if message.content %}
            {{- '\\n' + message.content }}
        {%- endif %}
        {%- for tool_call in message.tool_calls %}
            {%- if tool_call.function is defined %}
                {%- set tool_call = tool_call.function %}
            {%- endif %}
            {{- '\\n<tool_call>\\n{"name": "' }}
            {{- tool_call.name }}
            {{- '", "arguments": ' }}
            {{- tool_call.arguments | tojson }}
            {{- '}\\n</tool_call>' }}
        {%- endfor %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- message.content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
{%- endif %}
"""

GEMMA = (
    "{{ bos_token }}{% if messages[0]['role'] == 'system' %}{{ raise_exception('System role not supported') }}"
    "{% endif %}{% for message in messages %}{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}{% endif %}"
    "{% if (message['role'] == 'assistant') %}{% set role = 'model' %}{% else %}{% set role = message['role'] %}"
    "{% endif %}{{ '<start_of_turn>' + role + '\n' + message['content'] | trim + '<end_of_turn>\n' }}"
    "{% endfor %}{% if add_generation_prompt %}{{'<start_of_turn>model\n'}}{% endif %}"
)

# in the shape of Llama-3.1-Instruct's template: defaults through `is
# defined`, the system message sliced off `messages`, tools as JSON
LLAMA31 = """{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- set date_string = "26 Jul 2024" %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}

{#- This block extracts the system message, so we can slot it into the right place. #}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}

{{- "<|start_header_id|>system<|end_header_id|>\n\n" }}
{%- if builtin_tools is defined or tools is not none %}
    {{- "Environment: ipython\n" }}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\n" }}
{{- "Today Date: " + date_string + "\n\n" }}
{{- system_message }}
{{- "<|eot_id|>" }}

{%- if tools_in_user_message and not tools is none %}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
{%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\n\n' -}}
    {{- "Given the following functions, please respond with a JSON for a function call." }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\n\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' -}}
        {{- '{"name": "' + tool_call.name + '", ' }}
        {{- '"parameters": ' }}
        {{- tool_call.arguments | tojson }}
        {{- "}" }}
        {{- "<|eot_id|>" }}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\n\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' }}
{%- endif %}
"""

# every construct of the subset, with trim_blocks / lstrip_blocks at work
EVERYTHING = """{# a comment on its own line #}
{% set ns = namespace(count=0, last_role=none, sys='') %}
{% set greeting %}Hello {{ bos_token|default('no-bos') }}!{% endset %}
  {{ greeting|upper }} {{ greeting|lower|length }}
{% if messages|length > 0 and messages[0].role == 'system' %}
    {% set ns.sys = messages[0]['content']|trim %}
{%- endif %}
[{{ ns.sys }}]
{% for m in messages if m.role != 'system' %}
	{{ loop.index }}/{{ loop.length }} {{ loop.index0 }} {{ loop.revindex }} {{ loop.revindex0 }}
  {%- if loop.first %} first{% elif loop.last %} last{% else %} mid{% endif %}
  {%+ if m.content is string and m.content.strip().startswith('#') %}H{% endif %}
  {{ m.role ~ ':' ~ m.content|length }} {{ m.get('name', 'anon') }} {{ m.content[:3] }}|{{ m.content[-2:] }}
  {% set ns.count = ns.count + (2 ** 2) * 1 - 1 // 1 + 7 % 3 %}
  {% set ns.last_role = m.role %}
  {{ 'tools' if tools is not none else 'no tools' }} {{ 'x' in m.content }} {{ 'q' not in m.content }}
  {{ m.content.split(' ')|first }} {{ m.content.split(' ')|last }} {{ m.content.split()|join('-') }}
  {{ loop.previtem is defined }} {{ loop.nextitem is undefined }} {{ m is mapping }} {{ m.content is iterable }}
  {{- ' ' ~ (m.missing is defined) ~ (m.missing|default('dflt')) ~ (m['missing'] is none) }}
{% else %}
no messages
{% endfor %}
{{ ns.count }} {{ ns.last_role }} {{ [1, 2, 3][1:]|length }} {{ {'b': 1, 'a': [1, '<&>']}|tojson }}
{{ (tools or [])|tojson(indent=2) }} {{ range(3)|list }} {{ dict(a=1).items()|list }}
{{ -3 + 4 }} {{ 10 / 4 }} {{ 10 // 4 }} {{ 1 < 2 <= 2 }} {{ not false and true or false }} {{ none is none }}
{{ 3 is number }} {{ 3 is integer }} {{ true is boolean }} {{ 'a' is sequence }} {{ "it's" ~ '\\t"q"' }}
{% for k, v in {'x': 1, 'y': 2}.items() %}{{ k }}={{ v }}{{ ',' if not loop.last }}{% endfor %}

{%- if add_generation_prompt -%}
   <assistant>
{%- endif +%}
   tail   {{ eos_token|trim|capitalize }}
"""

WHITESPACE = """  {% if true %}
  x
  {% endif %}
  y  {#- c -#}  z
a  {%- if true -%}  \n b {%+ if true %}c{% endif %}
{% endif %}
\t{% for i in range(2) %}\t{{ i }}
\t{% endfor %}
{{- ' end ' -}}
   {% if false %}no{% else %}   yes   {% endif +%}
after
"""

TEMPLATES = {
    "default": DEFAULT_CHAT_TEMPLATE,
    "llama3": LLAMA3,
    "mistral": MISTRAL,
    "gemma": GEMMA,
    "llama31_tools": LLAMA31,
    "qwen_tools": QWEN_TOOLS,
    "everything": EVERYTHING,
    "whitespace": WHITESPACE,
}
TOOLS = [{"type": "function", "function": {"name": "get_weather", "description": "Weather <today> & 'now'",
                                           "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}]

BASIC = [
    [{"role": "user", "content": "hello world"}],
    [{"role": "system", "content": "  Be brief.  "}, {"role": "user", "content": "# Hi x"},
     {"role": "assistant", "content": "Hey q", "name": "bot"}, {"role": "user", "content": "again"}],
    [{"role": "user", "content": "héllo <b> & 'q' \"d\" {{ x }} {% y %}\n\nnew"},
     {"role": "assistant", "content": "", "tool_calls": [{"function": {"name": "f", "arguments": {"a": 1}}}]},
     {"role": "tool", "content": "42"}, {"role": "tool", "content": "43"}],
    [],
]


def render_both(src, messages, **kw):
    ref, port = RefTemplate(src, "<s>", "</s>"), PortTemplate(src, "<s>", "</s>")
    out = []
    for t in (ref, port):
        try:
            out.append(("ok", t.render(messages, **kw)))
        except ValueError:
            out.append(("raise", None))
        except Exception as e:  # noqa: BLE001 - jinja2's own errors
            out.append(("raise", type(e).__name__))
    return out


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_templates_render_like_jinja2(name):
    src = TEMPLATES[name]
    for messages in BASIC:
        for gen in (True, False):
            for tools in (None, TOOLS):
                ref, port = render_both(src, messages, add_generation_prompt=gen, tools=tools)
                assert port[0] == ref[0], (name, messages, ref, port)
                assert port[1] == ref[1] or ref[0] == "raise", (name, messages)


MESSAGE = st.fixed_dictionaries(
    {"role": st.sampled_from(["system", "user", "assistant", "tool"]),
     "content": st.lists(st.one_of(st.characters(codec="utf-8"), st.sampled_from(
         ["{{", "}}", "{%", "%}", "\n", "  ", "'", '"', "<", "&", "#", "x", "q"])),
         max_size=20).map("".join)},
    optional={"name": st.sampled_from(["a", "b"])},
)


@pytest.mark.parametrize("name", sorted(TEMPLATES))
@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(messages=st.lists(MESSAGE, max_size=5), gen=st.booleans(), with_tools=st.booleans())
def test_templates_render_like_jinja2_on_hypothesis_messages(name, messages, gen, with_tools):
    ref, port = render_both(TEMPLATES[name], messages, add_generation_prompt=gen,
                            tools=TOOLS if with_tools else None)
    assert port[0] == ref[0]
    if ref[0] == "ok":
        assert port[1] == ref[1]


SNIPPETS = [
    "{{ u }}|{{ u|length }}|{{ u is iterable }}|{{ u ~ 'x' }}|{{ u|default('d') }}",
    "{{ none }}|{{ None }}|{{ True }}|{{ 1.0 }}|{{ [1,'a'] }}|{{ {'a':None} }}|{{ (1, 2) }}",
    "{{ 'a\\nb' }}|{{ \"it's\" }}|{{ 'x' 'y' }}|{{ 'é\\u00e9' }}",
    "{{ 7 // 2 }} {{ 7 / 2 }} {{ 2 ** 3 }} {{ 7 % 3 }} {{ -3 }} {{ 'a' * 3 }} {{ 1_000 }}",
    "{% set x = 0 %}{% for i in range(3) %}{{ x }}{% set x = i %}{{ x }}{% endfor %}|{{ x }}",
    "{% for i in range(2) %}{% if i == 0 %}{% set y = 5 %}{% endif %}{{ y }}{% endfor %}{{ y }}",
    "{% if true %}{% set z = 3 %}{% endif %}{{ z }}",
    "{{ ('x'|tojson) + '<' }}{{ '<' + ('x'|tojson) }}{{ ('<'|tojson) ~ '<' }}",
    "{{ x.missing is defined }}{{ x['missing'] is defined }}{{ x.get('a', 'z') }}{{ x.keys()|list }}",
    "{{ none|trim }}|{{ 3|string }}|{{ 'ab'|first }}|{{ []|first }}|{{ []|last is defined }}",
    "{{ 'x' if false }}|{{ 'a' if 0 else 'b' }}|{{ 0 or '' }}|{{ true and 'x' }}",
    "{{ not u is defined }}{{ 1 in [1] }}{{ 'a' not in 'bcd' }}{{ 1 < 2 < 3 }}{{ 3 > 2 > 2 }}",
    "{{ 'A B'.split() }}{{ ' x '.strip() }}{{ 'ab'.startswith('a') }}{{ 'aXb'.split('X')[1] }}",
    "{%- for m in [1, 2] %}\n    {{- m }}\n{%- endfor %}",
    "{{ 1 == 1.0 }}{{ 'a' != 'b' }}{{ u == u }}{{ u == none }}{{ x[5] is defined }}{{ s.foo }}{{ s['y'] }}",
    "{{ 'abc'[0] }}{{ 'abcdef'[1:4:2] }}{{ [1, 2, 3][::-1] }}{{ [1, 2, 3][-1] }}",
    "{% set l = [] %}{% set _ = l.append(1) %}{{ l }}{{ l|length }}",
    "{{ 'Hello World'|replace('o', '0') }}{{ '3'|int + 1 }}{{ 'x,y'.split(',')|join(';') }}",
    "{% for i in [] %}x{% else %}empty{% endfor %}{{ loop }}",
    "{{ u + 1 }}",
    "{{ u.x }}",
    "{{ raise_exception('boom') }}",
    "{{ strftime_now('%Y') }}",
    "{{ [1, 2] < 3 }}",
]


@pytest.mark.parametrize("idx", range(len(SNIPPETS)))
def test_snippets_render_like_jinja2(idx):
    ref, port = render_both(SNIPPETS[idx], [], x={"b": 1}, s="abc")
    assert port[0] == ref[0], (SNIPPETS[idx], ref, port)
    assert port[1] == ref[1] or ref[0] == "raise", SNIPPETS[idx]


OUTSIDE = [
    "{% macro f(x) %}{{ x }}{% endmacro %}{{ f(1) }}",
    "{% raw %}{{ x }}{% endraw %}",
    "{{ messages|selectattr('role') }}",
    "{{ x is divisibleby(3) }}",
    "{% include 'other.j2' %}",
    "{% break %}",
    "{% set a, b = 1, 2 %}",
    "{% filter upper %}x{% endfilter %}",
    "{% for x in y recursive %}{% endfor %}",
    "{% if x %}unclosed",
    "{{ x @ y }}",
    "{{ x",
    "{% generation %}x{% endgeneration %}",
]


@pytest.mark.parametrize("src", OUTSIDE)
def test_syntax_outside_the_subset_raises_at_construction(src):
    with pytest.raises(TemplateSyntaxError):
        Template(src)


def test_lexer_normalises_newlines_and_drops_one_trailing_newline():
    assert lex("a\r\nb\rc\n") == [("data", "a\nb\nc")]
    assert Template("x\n\n").render() == RefTemplate("x\n\n").render([]) == "x\n"
