# Dev workflow targets (reference Makefile parity, minus Go/kind).
PY ?= python
TAG ?= latest

.PHONY: test test-stress race-test crash-test ha-test reshard-test net-chaos shm-chaos upgrade-test scenario-test shard-scenario reshard-scenario preempt-scenario partition-scenario replica-scenario scenario-regression scenario-hunt scenario-hunt-smoke scenario-hunt-long scenario-hunt-nightly lint ci gen bench bench-quick walkthrough smoke serve clean native image image-gpu serve-gpu walkthrough-gpu dev-cluster dev-run dev-teardown

native:          ## build the C++ selector row-match engine (auto-built on import too)
	$(PY) -c "from kube_throttler_tpu.native import load; import sys; \
		sys.exit(0 if load() is not None else 1)"

test:            ## unit + kernel + integration tiers (8-device virtual CPU mesh)
	$(PY) -m pytest tests/ -q

test-stress:     ## only the stress/concurrency tier
	$(PY) -m pytest tests/test_stress.py -q

race-test:       ## runtime-detector gate: planted races + planted stale verdicts MUST fire (file:line asserts) + detector-armed concurrency smoke + runtime retrace budget; the full suite runs armed anyway (conftest KT_RACE_DETECT=1 KT_EPOCH_ASSERT=1)
	env JAX_PLATFORMS=cpu KT_RACE_DETECT=1 KT_LOCK_ASSERT=1 KT_EPOCH_ASSERT=1 $(PY) -m pytest \
		tests/test_racedetect.py tests/test_retrace.py \
		tests/test_epochassert.py \
		tests/test_lockorder.py tests/test_concurrent_check.py \
		-q -p no:cacheprovider

crash-test:      ## SIGKILL crash-point matrix: every crash.* site x 3 seeds
	$(PY) tools/crashtest.py matrix

ha-test:         ## kill-the-leader failover matrix: every ha.* site x 3 seeds + split-brain fencing
	$(PY) tools/hatest.py matrix

reshard-test:    ## kill-mid-handoff abort matrix: every reshard.* abort path x 3 seeds, zero orphan reservations
	env JAX_PLATFORMS=cpu $(PY) tools/reshardtest.py matrix

scenario-test:   ## trace-driven scenario corpus x 3 seeds, every SLO gate enforced (+ the sharded bad-day variant + the live-resharding chaos scenario + the preemption storm + the TCP-fleet partition bad day + the replica serving tier + hunt-promoted regression repros)
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios matrix
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.sharded --shards 4 --seed 0
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.resharding --seed 0
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.preemption --seed 0
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.partition --seed 0
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.replica --seed 0
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios regressions

preempt-scenario: ## preemption storm alone: gang waves vs low-priority residents, victim-churn SLO gate
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.preemption --seed 0

shard-scenario:  ## sharded composed bad-day alone: 4 workers, kill-a-shard episode, knee-lift + zero-wrong-verdict gates
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.sharded --shards 4 --seed 0

reshard-scenario: ## live resharding alone: scale 2->4->3 under storm load with one kill-mid-handoff episode
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.resharding --seed 0

partition-scenario: ## TCP-fleet partition bad day alone: asymmetric partition + heal mid-storm, zero wrong verdicts / zero lost flips / fencing gates
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.partition --seed 0

replica-scenario: ## read-replica serving tier alone: storm + leader flip burst, verdict-oracle + lag-SLO + staleness/forwarding gates
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.replica --seed 0

net-chaos:       ## transport-fault matrix: every net.* site x 3 seeds through a live 2-worker TCP fleet + every shm.* site through a live socketpair fleet; verdict-oracle + zero-orphan + zero-lost-flip gates
	env JAX_PLATFORMS=cpu $(PY) tools/netchaostest.py matrix

shm-chaos:       ## shared-memory event-plane faults only: every shm.* site through a live socketpair fleet with the ring asserted ACTIVE pre-fault; restart-delta + verdict-oracle + zero-leaked-segment gates
	env JAX_PLATFORMS=cpu $(PY) tools/netchaostest.py matrix --only shm

upgrade-test:    ## rolling-upgrade chaos matrix: front-first + worker-first rolls with capability skew, mid-roll SIGKILL, and the clean incompatible-major refusal, over a live 3-worker TCP fleet
	env JAX_PLATFORMS=cpu $(PY) tools/upgradetest.py matrix

scenario-regression: ## prove the gates gate: clean vs injected-regression diff report
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios regression --name smoke

scenario-hunt:   ## nightly budgeted coverage-guided adversarial hunt; findings shrink + promote into scenarios/corpus/regressions/
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.hunt run \
		--budget-s 900 --iterations 40 --report hunt-report.json

scenario-hunt-smoke: ## CI acceptance: planted-bug find -> confirm -> shrink -> promote + coverage artifact
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.hunt smoke \
		--report hunt-coverage.json

scenario-hunt-long: ## long-horizon tier: multi-virtual-day soaks, durability cycles, 1M-pod arena rung
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.hunt long \
		--budget-s 3600 --iterations 20 --report hunt-long-report.json

scenario-hunt-nightly: ## nightly cadence (hack/ci.sh comments): the long tier at the FULL 1M-pod arena rung with durable journal/snapshot cycles, then budget-remainder mutation
	env JAX_PLATFORMS=cpu $(PY) -m kube_throttler_tpu.scenarios.hunt long \
		--budget-s 7200 --iterations 30 --mega-pods 1000000 \
		--report hunt-nightly-report.json

lint:            ## 15-checker static analyzer (locks, purity, registries, blocking, threads, excsafety, protocol, dtype, donation, retrace, envguard, epochs, deadlines, taint) + syntax sanity
	$(PY) -m compileall -q kube_throttler_tpu tools bench.py __graft_entry__.py
	$(PY) -m kube_throttler_tpu.analysis

ci:              ## the CI gate: lint + fast smoke tier (hack/ci.sh) — lint failures fail CI, not review
	hack/ci.sh

.PHONY: lint-torch race-test-torch ci-torch

lint-torch:      ## the PyTorch/CUDA port's twin of `lint`: compileall + its 12-checker static analyzer + stale-waiver gate
	$(PY) -m compileall -q kube_throttler_tpu_torch $(wildcard tools/*_torch.py) chip_smoke.py gather_timing.py victim_timing.py
	$(PY) -m kube_throttler_tpu_torch.analysis

race-test-torch: ## the PyTorch/CUDA port's twin of `race-test`: planted races + planted stale verdicts MUST fire + detector-armed concurrency smoke
	env KT_RACE_DETECT=1 KT_LOCK_ASSERT=1 KT_EPOCH_ASSERT=1 $(PY) -m pytest \
		tests/test_torch_racedetect.py tests/test_torch_epochassert.py \
		tests/test_torch_lockorder.py tests/test_torch_concurrent_check.py \
		-q -p no:cacheprovider

ci-torch:        ## the PyTorch/CUDA port's twin of `ci`: lint-torch + its fast smoke tier (hack/ci_torch.sh), all on the CPU
	hack/ci_torch.sh

gen:             ## regenerate deploy/crd.yaml from the typed API model
	$(PY) tools/gen_crd.py

image:           ## container image for deploy/deployment.yaml (Dockerfile)
	tools/build_image.sh

image-gpu:       ## container image of the PyTorch/CUDA port for deploy/gpu/ (Dockerfile.gpu; TAG=latest)
	docker build -f Dockerfile.gpu -t kube-throttler-gpu:$(TAG) .

serve-gpu:       ## run the PyTorch/CUDA port's daemon on the card
	$(PY) -m kube_throttler_tpu_torch.cli serve --name kube-throttler \
		--target-scheduler-name my-scheduler --port 10259

walkthrough-gpu: ## reference README walkthrough through the PyTorch/CUDA port, on the card
	$(PY) examples/walkthrough_torch.py

bench:           ## the five BASELINE.json configs (one JSON line on stdout)
	$(PY) bench.py

bench-quick:
	$(PY) bench.py --quick

walkthrough:     ## reference README walkthrough end-to-end
	$(PY) examples/walkthrough.py

smoke:           ## TPU kernel compatibility smoke on real hardware
	$(PY) tools/tpu_smoke.py

serve:           ## run the daemon against the sample config
	$(PY) -m kube_throttler_tpu.cli serve --name kube-throttler \
		--target-scheduler-name my-scheduler --port 10259

dev-cluster:     ## spin a kind cluster + CRDs/RBAC (needs kind/kubectl)
	hack/dev/up.sh

dev-run:         ## run the daemon in remote mode against the kind cluster
	hack/dev/run.sh

dev-teardown:    ## delete the dev kind cluster
	hack/dev/down.sh

clean:
	find . -name __pycache__ -type d -prune -exec rm -rf {} +
