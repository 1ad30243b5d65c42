# Top-level build/test/bench entry points (the counterpart of the
# reference's build/Makefile + CI pipeline; see SURVEY.md section 2.7).

PYTHON ?= python

.PHONY: all native test test-fast bench entry clean

all: native

# native host runtime (C++ classic-netCDF reader + OpenMP feature packing)
native:
	$(MAKE) -C native

# full suite on the virtual-CPU backend (tests/conftest.py forces cpu + 8
# virtual devices)
test:
	$(PYTHON) -m pytest tests/ -q

# quick smoke: core types + solvers + flagship end-to-end
test-fast:
	$(PYTHON) -m pytest tests/test_core_types.py tests/test_solvers.py \
	  tests/test_rfmip_nn.py -q

# headline benchmark on one GPU; prints the card and one JSON line
bench:
	$(PYTHON) bench.py

# driver entry checks: single-chip forward compile + 8-device mesh dry run
entry:
	$(PYTHON) __graft_entry__.py

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -prune -exec rm -rf {} +
