"""Llama configuration, stacked parameters, the serving step and
engine, the pretrain step, and the decoder families on the Paddle-shaped
surface (counterpart of `paddle_tpu/models`)."""
from .llama import LlamaConfig, LlamaModel, LlamaForCausalLM  # noqa: F401
from .gpt2 import GPT2Config, GPT2Model, GPT2LMHeadModel  # noqa: F401
from .moe_llm import MoEConfig, MoEForCausalLM  # noqa: F401
from .qwen2 import Qwen2Config, Qwen2Model, Qwen2ForCausalLM  # noqa: F401
from .deepseek import DeepSeekConfig, DeepSeekForCausalLM  # noqa: F401
from . import generation  # noqa: F401
