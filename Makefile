# pgslam_tpu build/test entry points (the reference's CMake analog).

.PHONY: all native test smoke bench verify clean

all: native

# The native library builds itself on first use, named after a hash of
# its sources (pgslam_tpu/native/__init__.py); this target just forces it.
native:
	python -c "from pgslam_tpu.native import native_available as a; assert a()"

test: native
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

smoke:
	python chip_smoke.py

bench: native
	python bench.py

verify: native
	python scripts/verify_drive.py

clean:
	rm -f pgslam_tpu/native/libpgslam_graph*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
