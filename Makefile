# Convenience targets (tests force the CPU backend; bench uses the default
# accelerator).

.PHONY: test test-fast coverage bench smoke entry native clean

test:
	python -m pytest tests/ -x -q

# the red/green loop: every module, minus the @pytest.mark.slow
# end-to-end runs (those stay in `make test`)
test-fast:
	python -m pytest tests/ -q -m "not slow"

# line coverage via the stdlib measurer (tools/stdlib_cov.py — the image
# has no coverage.py); writes coverage_report.txt
coverage:
	FVGP_COV=1 python -m pytest tests/ -q

bench:
	python bench.py

# the main path on the GPU (one card); `python chip_smoke.py --four` for the
# 4-card mesh phase
smoke:
	python chip_smoke.py

entry:
	JAX_PLATFORMS=cpu \
	XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	python __graft_entry__.py

native:
	python -c "from fvgp_tpu.native import get_lib; print(get_lib())"

clean:
	rm -rf fvgp_tpu/native/_build
	find . -name __pycache__ -type d -exec rm -rf {} +
