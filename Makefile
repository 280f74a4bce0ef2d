# Build/test entry points — counterpart of the reference's Makefiles
# (/root/reference/Makefile runs codegen + tests + build; tutorial/Makefile
# runs every study's selfcheck twice).  There is no codegen stage here —
# jax.grad replaces the deriv AD step wholesale.

PY ?= python
CXX ?= g++

.PHONY: all test test-all selfcheck bench native clean

all: native test selfcheck

# Native runtime helpers (host-side C++; the compute path is JAX/XLA).
# Loaded through ctypes — see gogp/utils/native.py; pure-Python
# fallbacks keep everything working unbuilt.
native: native/libgogp_native.so

native/libgogp_native.so: native/csv_parser.cpp native/loader.cpp
	$(CXX) -O2 -shared -fPIC -pthread -o $@ native/csv_parser.cpp native/loader.cpp

# Quick tier (~8 min): the sampler-moment long tail (tests/slow_tests.txt,
# measured >4 s each) is excluded; every module keeps its fast tests.
test:
	$(PY) -m pytest tests/ -q -m "not slow"

# Everything (~37 min), including the slow tier.
test-all:
	$(PY) -m pytest tests/ -q

# Every case study end-to-end on its embedded dataset (reference
# tutorial/Makefile loops the five studies; serial-vs-parallel duplication
# is replaced by the batched-vs-sequential paths covered in tests/).
selfcheck:
	$(PY) -m gogp.tutorial.barebones   --seed 0 selfcheck > /dev/null
	$(PY) -m gogp.tutorial.hyperpriors --seed 0 selfcheck > /dev/null
	$(PY) -m gogp.tutorial.warpedtime  --seed 0 selfcheck > /dev/null
	$(PY) -m gogp.tutorial.anynoise    --seed 0 selfcheck > /dev/null
	$(PY) -m gogp.tutorial.events      --seed 0 --events 1.0:1.0:0.5,4.2:6.7:0.25 selfcheck > /dev/null
	$(PY) -m gogp.tutorial.classify    --seed 0 --iters 60 selfcheck > /dev/null
	@echo "selfchecks ok"

bench:
	$(PY) bench.py
	$(PY) benchmarks/ess_nuts.py

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
