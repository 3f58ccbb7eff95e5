# Developer entry points (counterpart of the reference's Makefile targets,
# /root/reference/Makefile:13-31,90-92, minus the MPI/FFTW build machinery
# that the JAX stack does not need).

.PHONY: test test-fast test-gpu bench bench-small smoke lint examples-smoke

test:
	python -m pytest tests/ -x -q

test-fast:
	python -m pytest tests/ -x -q -k "not simulator and not interaction"

bench:
	python bench.py

bench-small:
	BENCH_GRID=128 BENCH_STEPS=10 python bench.py

smoke:
	python chip_smoke.py

test-gpu:
	JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m gpu

lint:
	python -m compileall -q sopht_mpi_tpu examples tests bench.py __graft_entry__.py chip_smoke.py

examples-smoke:
	JAX_PLATFORMS=cpu python examples/2d/lamb_oseen_vortex.py --grid-size 64
