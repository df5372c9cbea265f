# Developer entry points (the CI-equivalent lives in `make check`).

PY ?= python

.PHONY: check check-gpu test native dryrun golden clean

native:
	$(MAKE) -s -C chalametpir_tpu/native libchalametpir_native.so

test: native
	$(PY) -m pytest tests/ -q

dryrun:
	$(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('dryrun OK')"

golden:
	$(PY) -m pytest tests/test_golden_interop.py -q

# The full pre-merge gate: native build + unit/integration/golden tests on
# the 8-device virtual CPU mesh + the multi-chip dryrun (mirrors the
# reference's CI matrix of cargo test + wasm runs, test_ci.yml:1-49).
check: test dryrun
	@echo "check: OK"

# Chip tier: the compiled-mode assertions (tests/test_gpu_compiled.py) on a
# GPU — the analogue of the reference CI running its suite with
# --features gpu (test_ci.yml:36-48).
check-gpu: native
	PIR_TEST_GPU=1 $(PY) -m pytest tests/ -m gpu -q
	@echo "check-gpu: OK"

clean:
	$(MAKE) -s -C chalametpir_tpu/native clean
