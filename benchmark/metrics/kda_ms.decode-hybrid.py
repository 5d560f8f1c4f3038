"""kda_ms.decode-hybrid: device ms of the KDA mixers in a call's prefill
(the program's ``kda.mix`` spans); see ``readers_kimi.kda_ms``."""

from benchmark.readers_kimi import kda_ms as read  # noqa: F401
