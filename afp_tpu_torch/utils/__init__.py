"""Host utilities of the port: WAV I/O and logging (copies of
`afp_tpu/utils/wavio.py` and `afp_tpu/utils/log.py`)."""
from .log import RateLimited, get_logger
from .wavio import read_wav, read_wav_pcm16, write_wav, write_wav_pcm16

__all__ = ["RateLimited", "get_logger", "read_wav", "read_wav_pcm16",
           "write_wav", "write_wav_pcm16"]
