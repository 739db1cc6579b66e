"""Examples of the port (counterparts of the repo's `examples/`), each run
as ``python -m afp_tpu_torch.examples.<name>`` on the card, or on the CPU
under ``AFP_FORCE_CPU=1``; with neither they exit non-zero:

* `baseline_stream`: the C5 chain under the simulated-clock stream;
* `eq_stream`: the 9- or 3-band EQ with a live gain change;
* `agc_stream`: the AGC behind the exact ASRC;
* `presets_stream`: presets, config clamps and a checkpointed resume;
* `waterfall_stream`: a swept tone's spectra in the depth-50 ring;
* `per_stream_banks`: a filter design per stream, and per-stream AGC;
* `ring_serving`: the C5 headline served through the device rings;
* `long_kernel_parallel`: a 50 000-tap FIR sharded over 8 mesh shards;
* `live_audio`: the sound card (prints the devices without PortAudio).

Files they write (plots, presets, checkpoints) go to ``--out-dir``
(``build/examples`` by default).  The plots need matplotlib; without it
the examples say so and write none.
"""
