# ninpol_tpu build/test/bench targets (reference Makefile:1-34 analogue;
# no compile step is required for the Python package itself — the native
# topology library auto-builds on first import).
PY ?= python

all: native

# -ffp-contract=off is REQUIRED: the f32 geometry kernels must stay
# bit-identical to the NumPy reference path (FMA contraction changes
# the normals' rounding and breaks the float32-parity tests)
native:
	g++ -O3 -march=native -ffp-contract=off -shared -fPIC -std=c++17 \
	    ninpol_tpu/native/topology.cpp -o ninpol_tpu/native/_ninpol_topology.so

test:
	env JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

# fast high-coverage subset (~2 min warm): oracle test per method,
# topology/geometry invariants, one sharding test
smoke:
	env JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m smoke

bench:
	$(PY) bench.py

perf:
	$(PY) tests/performance_harness.py
	$(PY) tests/results/graph.py

clean:
	rm -f ninpol_tpu/native/_ninpol_topology.so
	find . -name __pycache__ -type d -exec rm -rf {} +

.PHONY: all native test smoke bench perf clean
