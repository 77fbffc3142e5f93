"""The benchmark of the PyTorch and CUDA port (``repro_torch``): open-loop
multi-LLM serving on one NVIDIA H100.

One command runs one cell once (``python3 -m muxbench.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``).  Everything a cell is
made of is data found by name: ``BENCHMARK.json`` at the repository root
names the cells; a cell's configuration is ``configs/<name>.json``, its
traffic mix ``traffic/<name>.json`` (read by the one generator in
``traffic/generator.py``), each metric a reader of its own,
``metrics/<metric>.py``, and each model family (found by a model
entry's ``reference`` key) a module ``families/<reference>.py`` (its
leaves, step bounds, kernel groups and CPU size) beside its plain
reference ``reference/<reference>.py``.  The yardstick lives here and
nowhere in the program: the traffic generator, the peaks and the byte
and FLOP counts (``bounds.py``, ``families/``), the weights drawn from
the seed (``weights.py``) and the plain float32 reference that decides
``correct`` (``reference/``), which imports nothing of the program.
"""
