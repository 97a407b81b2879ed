"""Model size presets: full production dims and tiny offline-test dims.

Full dims mirror the checkpoints the reference deploys
(``Cluster/InfernTTSWorker.py:37-45`` SpeechT5 per language,
``Cluster/InfernSTTWorker.py:25`` whisper-large-v3,
``Cluster/InfernLLMWorker.py:64`` Qwen2.5-14B-Instruct); tiny dims keep
end-to-end tests fast on CPU with random weights.

Port of ``infernos_tpu/models/presets.py``.  The tiny random Whisper dims
(head dim 12) run on the CPU only: the encoder attention kernel takes head
dim 64.
"""

from __future__ import annotations

from . import hifigan as hfg
from . import qwen
from . import speecht5 as st5
from . import vad as vad_m
from . import whisper as wsp

# -- full-size (production) ----------------------------------------------------

SPEECHT5_FULL = st5.SpeechT5Config()
HIFIGAN_FULL = hfg.HifiGanConfig()
WHISPER_LARGE_V3 = wsp.WhisperConfig()
QWEN25_14B = qwen.QwenConfig()
# Qwen2.5-7B-Instruct dims: the serving point of LLMActor (int8 weights,
# about 8.7 GB).  The 14B target fits one 80 GB H100 whole: 15.2 GiB of
# weights in int8 or 27.5 GiB in bf16, plus 3.0 GiB of bf16 KV cache for 8
# slots x 2048 (parallel/budget.py; tests/test_torch_parallel_specs.py);
# tensor parallelism over several cards (LLMEngine(mesh=)) is for cards
# that cannot hold a model
QWEN25_7B = qwen.QwenConfig(
    vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
    num_kv_heads=4, head_dim=128, intermediate_size=18944,
    rope_theta=1000000.0, max_positions=32768,
)
VAD_FULL = vad_m.VADConfig()

# -- tiny (tests / smoke) -------------------------------------------------------

SPEECHT5_TINY = st5.SpeechT5Config(
    vocab_size=64, hidden_size=48, encoder_layers=2, encoder_attention_heads=4,
    encoder_ffn_dim=96, decoder_layers=2, decoder_attention_heads=4,
    decoder_ffn_dim=96, num_mel_bins=20, speech_decoder_prenet_units=24,
    speech_decoder_prenet_layers=2, speech_decoder_postnet_units=24,
    speech_decoder_postnet_layers=2, reduction_factor=2,
    speaker_embedding_dim=16, max_text_positions=128, max_speech_positions=512,
    encoder_max_relative_position=32,
)
HIFIGAN_TINY = hfg.HifiGanConfig(
    model_in_dim=20, upsample_initial_channel=32, upsample_rates=(4, 4),
    upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),),
)
WHISPER_TINY_TEST = wsp.WhisperConfig(
    vocab_size=128, num_mel_bins=20, d_model=48, encoder_layers=2,
    encoder_attention_heads=4, decoder_layers=2, decoder_attention_heads=4,
    ffn_dim=96, max_source_positions=400, max_target_positions=64,
    eos_token_id=2, sot_token_id=3, no_speech_token_id=4,
)
QWEN_TINY = qwen.QwenConfig(
    vocab_size=300, hidden_size=48, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=12, intermediate_size=96, rope_theta=10000.0, max_positions=512,
    eos_token_id=2, tie_word_embeddings=False,
)
