"""The plain reference that decides ``correct``: F5-TTS's DiT, E2-TTS's UNetT,
Vocos, the flow-matching sampler and the mel front end, written out in plain
PyTorch from the published equations (SWivid/F5-TTS ``model/``), in float32
with TF32 off. It imports nothing of the program and takes no tensor the
program made: the benchmark hands both sides the same weights and inputs,
and the reference works out again whatever the program derives from them
(mels, token ids, durations, noise).

One module per family, named as a configuration's ``family`` and its
vocoder's: a backbone's has ``forward``, a vocoder's ``log_mel``, ``decode``
and ``samples``. ``sampler.solve`` finds them by those names.

``layers.PRECISION["all"] = "fp8"`` holds every tensor in float8 e4m3: the
reference put in the program's place one precision below the bf16 the
configurations serve in, which the comparison must refuse (a control).
"""
