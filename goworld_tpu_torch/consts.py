"""Centralized compile-time tunables.

Mirrors the role of the reference's ``engine/consts/consts.go:6-137``: every
magic number that shapes runtime behavior lives here so operators can audit
them in one place.
"""

# --- ticking ----------------------------------------------------------------
# Reference runs 5 ms ticks on game/gate/dispatcher (consts.go:36,46,57).
GAME_SERVICE_TICK_INTERVAL = 0.005  # seconds
GATE_SERVICE_TICK_INTERVAL = 0.005
DISPATCHER_SERVICE_TICK_INTERVAL = 0.005

# --- networking -------------------------------------------------------------
MAX_PACKET_SIZE = 25 * 1024 * 1024  # reference PacketConnection.go:23
SIZE_FIELD_SIZE = 4  # 4-byte little-endian length prefix
PAYLOAD_LEN_MASK = 0x7FFFFFFF  # high bit reserved (reference: compressed flag)
CONNECTION_WRITE_BUFFER_SIZE = 1024 * 1024  # consts.go:14-61
CONNECTION_READ_BUFFER_SIZE = 1024 * 1024
BUFFERED_IO_SIZE = 16 * 1024
FLUSH_INTERVAL = 0.005  # auto-flush cadence (GoWorldConnection.go:437-452)

# --- dispatcher queue bounds (consts.go:30-34) ------------------------------
ENTITY_PENDING_PACKET_QUEUE_MAX_LEN = 1000
GAME_PENDING_PACKET_QUEUE_MAX_LEN = 1_000_000
DISPATCHER_MESSAGE_QUEUE_LEN = 10_000

# --- timeouts ---------------------------------------------------------------
DISPATCHER_MIGRATE_TIMEOUT = 60.0  # consts.go (1 min migrate window)
DISPATCHER_LOAD_TIMEOUT = 60.0
# Freeze buffering window (reference: 10 s, consts.go FREEZE_GAME_TIMEOUT).
# A restarting game here is a fresh Python interpreter (~2-4 s import cost
# per game, restarted sequentially by the CLI); 10 s leaves no headroom on a
# loaded box and an expired block DROPS packets instead of buffering them.
DISPATCHER_FREEZE_GAME_TIMEOUT = 30.0
# Freeze fence: each dispatcher's ack is emitted on the same TCP stream
# strictly after it installs the block, so processing the N-th ack IS the
# proof that every pre-block packet has been processed (game/service.py
# main loop). The quiescence knobs below are only the SAFETY NET for the
# all-acks-never-arrive case (dead dispatcher), entered after
# FREEZE_ACK_TIMEOUT.
FREEZE_ACK_TIMEOUT = 10.0
FREEZE_QUIESCENT_WINDOW = 0.3
FREEZE_DRAIN_CAP = 5.0
RECONNECT_INTERVAL = 1.0  # DispatcherConnMgr reconnect backoff (base)
# Reconnect backoff ceiling: delays grow base * 2^attempt with full jitter
# up to this cap, so a dead dispatcher isn't hammered at 1 Hz by every
# process in the deployment AND a thundering-herd reconnect (all games +
# gates at once after a dispatcher restart) is spread out.
RECONNECT_INTERVAL_MAX = 15.0
CLIENT_HEARTBEAT_TIMEOUT = 30.0  # gate kills silent clients

# --- cluster-link resilience ([cluster] ini section overrides) --------------
# Byte cap of the per-link replay ring: sends to a down dispatcher buffer
# here (drop-OLDEST on overflow, counted on cluster_dropped_packets_total)
# and replay right after the reconnect handshake. 0 restores the legacy
# drop-on-down behavior.
CLUSTER_DOWN_BUFFER_BYTES = 2 * 1024 * 1024
# Liveness deadline for game/gate↔dispatcher links: both ends send a
# HEARTBEAT msgtype on idle links (every timeout/3) and close a link silent
# past the timeout, converting a half-open TCP connection into the normal
# reconnect path instead of an indefinite stall. 0 disables.
CLUSTER_PEER_HEARTBEAT_TIMEOUT = 10.0
# Default wait_connected() deadline (DispatcherClusterBase).
CLUSTER_WAIT_CONNECTED_TIMEOUT = 10.0
# Dispatcher-side reconnect grace: with replay-buffered links a blip is
# steady-state, so an UNPLANNED game/gate disconnect buffers that peer's
# packets for this window (like the freeze window) instead of instantly
# wiping routes / broadcasting peer-death — the reconnect handshake flushes
# the buffer; only a window that lapses becomes a real death. The same
# window buffers packets for not-yet-routed entities (a gate's ring replay
# racing the game's re-handshake into a restarted dispatcher).
DISPATCHER_RECONNECT_BUFFER_WINDOW = 5.0
# Size trigger for position-sync aggregation buffers (dispatcher per-game
# and gate per-dispatcher): a buffer reaching this many bytes flushes
# immediately instead of waiting out the tick/sync interval, so a burst
# pays latency proportional to its size, not the flush cadence.
# 0 disables the trigger ([cluster] sync_flush_bytes overrides).
DISPATCHER_SYNC_FLUSH_BYTES = 32 * 1024

# --- telemetry / tracing ([telemetry] ini section overrides) -----------------
# Head-sampling denominator for distributed traces: 1-in-N ingress events
# (gate client RPC, game timer tick) mint a TraceContext that rides cluster
# packets as a 17-byte trailer. 0 disables tracing entirely; unsampled
# traffic is wire-identical either way (telemetry/tracing.py).
TRACE_SAMPLE_RATE = 1024
# Finished-span ring per process (drop-oldest, trace_spans_dropped_total).
TRACE_RING_SIZE = 4096
# Slow-tick flight recorder: a game tick busier than this many seconds
# dumps the last FLIGHT_RING_SIZE tick records + the tick's sampled spans
# as ONE structured WARN (kept on GET /flight). Default 0.1 s ≈ 2x the
# ~48 ms busy tick of the committed pinned-floor config (BENCH_FLOOR.json:
# 2048 entities / 42k upd/s) — production 5 ms ticks only ever get near it
# when something is genuinely wrong (jit recompile, storage stall, GC).
SLOW_TICK_BUDGET = 0.1
FLIGHT_RING_SIZE = 240

# --- persistence ------------------------------------------------------------
DEFAULT_SAVE_INTERVAL = 300.0  # 5 min (read_config.go:28)
# Save-retry backoff: the reference retries forever at a fixed 1 s
# (storage.go:197-240); here the delay doubles per consecutive failure up
# to the cap, and after STORAGE_CIRCUIT_FAILURE_THRESHOLD consecutive
# failures the per-backend circuit OPENS: further saves defer into a
# byte-capped queue (keeping the single storage worker live for the other
# entities) until a half-open probe after STORAGE_CIRCUIT_COOLDOWN
# succeeds. All overridable via the [storage] ini section.
STORAGE_RETRY_BASE_INTERVAL = 1.0
STORAGE_RETRY_MAX_INTERVAL = 30.0
STORAGE_CIRCUIT_FAILURE_THRESHOLD = 5
STORAGE_CIRCUIT_COOLDOWN = 5.0
STORAGE_DEFERRED_BYTES_CAP = 8 * 1024 * 1024

# --- AOI compute plane ------------------------------------------------------
# Default fixed neighbor-set capacity per entity on the batched path. The
# reference's go-aoi has no cap; interest sets in practice are bounded by
# design caps (e.g. 100 avatars/space, unity_demo/SpaceService.go:13-15).
AOI_MAX_NEIGHBORS = 128
# Default per-cell capacity of the spatial hash grid (padded, static shape).
AOI_CELL_CAPACITY = 64
# Default position-sync cadence (read_config.go:328,380 → 100 ms).
POSITION_SYNC_INTERVAL = 0.1

# --- debug switches ---------------------------------------------------------
DEBUG_PACKETS = False
DEBUG_SPACES = False
DEBUG_SAVE_LOAD = False
DEBUG_CLIENTS = False
DEBUG_MIGRATE = False

# --- supervisor start tags (binutil consts.go:133-137) ----------------------
# Printed once a process is serving; the CLI start command scans child logs
# for these to sequence dispatchers -> games -> gates.
DISPATCHER_STARTED_TAG = "SUPERVISOR: dispatcher started ok"
GAME_STARTED_TAG = "SUPERVISOR: game started ok"
GATE_STARTED_TAG = "SUPERVISOR: gate started ok"
FREEZED_TAG = "SUPERVISOR: game freezed"
