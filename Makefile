# Developer entry points.
.PHONY: test native bench smoke profile schemas audit clean

test:
	JAX_PLATFORMS=cpu python -m pytest tests -q -m 'not slow'

native:
	$(MAKE) -C native

bench:
	python bench.py

smoke:
	python chip_smoke.py

profile:
	python scripts/profile_index.py --clustered
	python scripts/profile_signals.py

schemas:
	python -m dewi.schemas

audit:
	python scripts/gatekeeper_audit.py

clean:
	$(MAKE) -C native clean
	rm -rf .pytest_cache dewi/__pycache__
