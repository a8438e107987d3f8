"""INI configuration shared by every process in a deployment.

Reference parity: ``engine/config/read_config.go`` — one ``goworld.ini`` read
by dispatchers, gates, games and the CLI. Sections (read_config.go:239-314):

- ``[deployment]``: desired process counts — also the readiness barrier
  (DispatcherService.go:446-476).
- ``[dispatcherN]`` / ``[gameN]`` / ``[gateN]``: per-process sections, each
  inheriting defaults from ``[dispatcher_common]`` / ``[game_common]`` /
  ``[gate_common]`` (read_config.go:316-470).
- ``[storage]``, ``[kvdb]``, ``[debug]``.

Compute-plane addition: ``[aoi]`` configures the batched AOI engine
(backend, capacities, device mesh axis sizes) — no reference analog.

The port reads the JAX package's ``goworld.ini`` unchanged but for one
value: ``[aoi] platform`` (and ``[gameN] aoi_platform``) take
``auto | cpu | cuda``, where ``auto`` and ``cuda`` both mean the CUDA card
and ``tpu`` is refused at load. ``[aoi] backend = tpu`` still names the
batched engine, as the JAX ini spells it. ``[aoi] compilation_cache`` is
read and has no effect: nothing compiles lazily in PyTorch, and the CUDA
libraries are built once into the hashed ``goworld_tpu_torch/_build/``
(``ops/_build.py``; the CLI builds them before it spawns games).
"""

from __future__ import annotations

import configparser
import dataclasses
import threading
from typing import Optional

DEFAULT_CONFIG_FILES = ("goworld.ini",)


@dataclasses.dataclass
class DeploymentConfig:
    desired_games: int = 1
    desired_gates: int = 1
    desired_dispatchers: int = 1


@dataclasses.dataclass
class DispatcherConfig:
    host: str = "127.0.0.1"
    port: int = 0
    http_addr: str = ""
    log_file: str = ""
    log_level: str = "info"

    @property
    def addr(self) -> tuple[str, int]:
        return (self.host, self.port)


@dataclasses.dataclass
class GameConfig:
    boot_entity: str = ""
    save_interval: float = 300.0
    http_addr: str = ""
    log_file: str = ""
    log_level: str = "info"
    position_sync_interval: float = 0.1  # server→client cadence (read_config.go:328)
    # Per-game override of [aoi] platform ("" = inherit): auto | cpu | cuda,
    # e.g. cpu on the games that must stay off the card.
    aoi_platform: str = ""


@dataclasses.dataclass
class GateConfig:
    host: str = "127.0.0.1"
    port: int = 0
    ws_addr: str = ""  # websocket listen addr ("host:port" or "")
    http_addr: str = ""
    log_file: str = ""
    log_level: str = "info"
    compress_connection: bool = False
    # Codec when compress_connection is on. "snappy" fills the slot the
    # reference fills with snappy (ClientProxy.go:42-45), but the WIRE
    # deliberately diverges: the reference wraps the whole connection in
    # snappy STREAM framing, while this engine compresses each packet
    # independently with the snappy BLOCK format, selected per packet by a
    # length-prefix flag bit (netutil/packet_conn.py) — so enabling is
    # one-sided safe and tiny packets skip the codec. Both in-repo ends
    # match; reference Go clients would NOT interoperate on this wire.
    # zlib retained as an option.
    compress_format: str = "snappy"  # snappy | zlib
    # Reliable-UDP wire protocol beside TCP: "kcp" = the real KCP segment
    # protocol (reference parity, GateService.go:134-165 via kcp-go;
    # netutil/kcp.py); "native" = the in-repo ARQ (netutil/rudp.py).
    rudp_protocol: str = "kcp"  # kcp | native
    # FEC shards for the kcp protocol ("data,parity"; "off" disables).
    # 10,3 is the reference's exact dial shape (ListenWithOptions(addr,
    # nil, 10, 3)): every 10 data datagrams carry 3 Reed-Solomon parity
    # datagrams so lost packets reconstruct without a retransmit RTT.
    # Clients must match (netutil/fec.py).
    rudp_fec: str = "10,3"
    encrypt_connection: bool = False
    rsa_key: str = ""
    rsa_cert: str = ""
    heartbeat_timeout: float = 30.0
    position_sync_interval: float = 0.1  # client→server coalescing cadence

    @property
    def addr(self) -> tuple[str, int]:
        return (self.host, self.port)


@dataclasses.dataclass
class ClusterConfig:
    """Game/gate↔dispatcher link resilience knobs (``[cluster]``; defaults
    mirror consts.py — no reference analog: GoWorld drops packets to down
    dispatchers and reconnects on a fixed 1 s interval)."""

    # Byte cap of the per-link replay ring buffering sends while a
    # dispatcher link is down (0 = legacy drop-on-down).
    down_buffer_bytes: int = 2 * 1024 * 1024
    # Close links silent past this many seconds (HEARTBEAT msgtype sent on
    # idle links every timeout/3 by both ends); 0 disables liveness kills.
    peer_heartbeat_timeout: float = 10.0
    # Default deadline of ClusterClient.wait_connected().
    wait_connected_timeout: float = 10.0
    # Reconnect backoff ceiling (base is consts.RECONNECT_INTERVAL;
    # delays are full-jittered).
    reconnect_max_interval: float = 15.0
    # Cluster-link transport: "tcp" (default) or "uds" — Unix-domain
    # game↔dispatcher↔gate sockets for co-located single-host deploys
    # (same framing/heartbeats/replay rings; dispatchers serve BOTH
    # listeners, games/gates dial the socket path derived from each
    # dispatcher's configured port — dispatchercluster.cluster.uds_path_for).
    transport: str = "tcp"
    # Directory holding the uds socket files ("" = system temp dir; keep
    # it short — sun_path caps at ~108 bytes).
    uds_dir: str = ""
    # Size trigger for position-sync aggregation buffers (dispatcher
    # per-game, gate per-dispatcher): flush immediately once a buffer
    # reaches this many bytes instead of sitting out the tick/sync
    # interval. 0 disables the trigger (tick-interval flush only).
    sync_flush_bytes: int = 32 * 1024


@dataclasses.dataclass
class StorageConfig:
    type: str = "filesystem"
    directory: str = "_entity_storage"  # filesystem backend
    url: str = ""  # network backends
    db: str = "goworld"
    # redis_cluster seed nodes, from ``start_nodes_N = host:port`` keys
    # (reference read_config.go:492-493).
    start_nodes: list = dataclasses.field(default_factory=list)
    # Save-retry / circuit-breaker knobs (storage/__init__.py): retries
    # back off retry_base_interval → retry_max_interval (doubling); after
    # circuit_failure_threshold consecutive failures the circuit opens and
    # saves defer into a deferred_bytes_cap-bounded queue until a
    # half-open probe (after circuit_cooldown seconds) succeeds.
    retry_base_interval: float = 1.0
    retry_max_interval: float = 30.0
    circuit_failure_threshold: int = 5
    circuit_cooldown: float = 5.0
    deferred_bytes_cap: int = 8 * 1024 * 1024


@dataclasses.dataclass
class KVDBConfig:
    type: str = "filesystem"
    directory: str = "_kvdb"
    url: str = ""
    db: str = "goworld"
    collection: str = "kvdb"
    start_nodes: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AOIConfig:
    """Compute-plane knobs (no reference analog; see SURVEY.md §7)."""

    backend: str = "auto"  # auto | xzlist | tpu (tpu = the batched engine)
    # Device of the batched engine: "auto" and "cuda" put it on the CUDA
    # card, and a game that finds none exits with the runtime's error (it
    # never falls back to the CPU); "cpu" runs the kernels' plain versions
    # for CPU-only deploys. "tpu" is the JAX package's value and is refused.
    platform: str = "auto"  # auto | cpu | cuda
    cell_capacity: int = 64
    max_entities: int = 16384  # padded capacity of the batched engine
    mesh_shards: int = 1  # device shards of the batched engine's mesh
    # How mesh_shards > 1 splits the work: "spatial" shards the AOI grid
    # into column strips with halo exchange (O(boundary) comms,
    # parallel/spatial.py; on TPU the strip-local Pallas kernel tier);
    # "entity" shards entity rows with a full all-gather per tick
    # (parallel/mesh.py).
    shard_mode: str = "spatial"  # spatial | entity
    # Strip→device placement of the spatial tier: "topology" reorders the
    # mesh from device coords so ring-adjacent strips land on
    # interconnect-adjacent chips (AoiZora-style; identity on rigs
    # without coords), "ring" keeps the mesh order as given.
    strip_placement: str = "topology"  # topology | ring
    # Static strip-width cap (columns) of the Pallas spatial tier's
    # kernel slab. 0 = derive (2x the uniform strip width, clamped to
    # planner feasibility). Ignored by the jnp spatial backend.
    pallas_strip_cols: int = 0
    # In-kernel event drain of the Pallas spatial tier: the kernel launch
    # itself emits the compacted (slot, slot) event pairs through SMEM
    # cursors, so a steady strip tick needs no XLA rank-select pass.
    # Overflowing ticks repage wholly through the XLA drain (exact).
    # Ignored by the jnp spatial backend.
    pallas_inkernel_drain: bool = True
    # Grid geometry (0 = derive from max_entities; see params_from_config).
    grid: int = 0  # cells per side (grid_x = grid_z)
    cell_size: float = 0.0  # cell side length; must be >= max AOI distance
    space_slots: int = 0  # space-id folding slots
    # Multi-HOST (DCN) tier: every game process joins ONE jax.distributed
    # mesh and the AOI step runs as multi-controller SPMD across them
    # (parallel/multihost.py). Set the coordinator to "host:port" (served
    # by the first game); processes defaults to the number of games. The
    # AOI tick then runs in LOCKSTEP at the fixed position_sync_interval
    # cadence on every game (collectives require every process to dispatch
    # the same op sequence). Mutually exclusive with mesh_shards > 1.
    multihost_coordinator: str = ""  # "" = disabled
    multihost_processes: int = 0  # 0 = len(games)
    # The JAX package's persistent XLA compilation cache. Read and given
    # no effect in the port: nothing compiles lazily in PyTorch, and the
    # CUDA libraries live in the hashed goworld_tpu_torch/_build/
    # (ops/_build.py), built once by the CLI before it spawns games.
    compilation_cache: str = "auto"  # auto | off | <dir>
    # Delivery model of the batched engine: "pipelined" (default — diffs
    # land one game tick late, the loop never stalls on device compute) or
    # "sync" (diffs land the same tick, within one readback of the step
    # completing — the p99 < 5 ms axis — at the cost of the logic loop
    # stalling for the step's device time every AOI tick). xzlist is
    # inherently synchronous and ignores this.
    delivery: str = "pipelined"  # pipelined | sync
    # Sync-mode stall ceiling (seconds): how long one AOI tick may block
    # the logic loop waiting for the device before the step is parked for
    # deferred (pipelined-style) delivery and aoi_sync_degrade_total
    # increments. Sub-second by default so a slow/wedged device degrades
    # to one-tick-late diffs instead of freezing every RPC (the old
    # hardcoded bound was 30 s). Ignored unless
    # delivery = sync.
    sync_wait_budget: float = 0.5
    # Fuse per-class columnar tick programs (entity/columns.columnar_tick
    # / vmapped_position_tick) INTO the batched engine's step launch:
    # steady-state ticks then run move + entity logic + neighbor interest
    # as ONE device launch, logic riding the AOI cadence with its outputs
    # written back at the next dispatch. Classes with hand-written
    # on_tick_batch bodies — and the entity-sharded/multihost engine
    # tiers — automatically stay host-side. Ignored by xzlist.
    fuse_logic: bool = False


@dataclasses.dataclass
class EntityConfig:
    """Columnar entity-slab knobs (``[entity]``; entity/slabs.py)."""

    # Initial slot capacity of the per-process entity slab store. The
    # store doubles on demand, so this is purely a pre-sizing knob: set it
    # near the expected steady-state entity count to avoid growth
    # reallocation (and, with the batched AOI backend, early engine tier
    # jumps) during login storms.
    slab_initial: int = 256


@dataclasses.dataclass
class SyncConfig:
    """Adaptive per-client position sync (``[sync]``; entity/slabs.py —
    ROADMAP item 5: per-client cost must go sublinear in neighbors x tick
    rate). Defaults preserve the legacy full-rate/full-precision path
    bit-for-bit."""

    # Per-tier emission periods in collections, ascending, first must be 1
    # (tier 0 = near neighbors at full rate). ("1",) disables tiering.
    tier_cadences: tuple[int, ...] = (1,)
    # Delta records carry int16 multiples of 2^-quantize_bits world units
    # between keyframes; 0 = full-precision records only (delta off).
    quantize_bits: int = 0
    # Collections between forced full-precision keyframes per pair.
    keyframe_interval: int = 32
    # distance/AOI-radius classification band: <= near_ratio -> tier 0,
    # >= far_ratio -> last tier, linear spread between.
    near_ratio: float = 0.5
    far_ratio: float = 0.8
    # Host-side re-classification cadence (collections); the batched AOI
    # engine's in-launch tier pass supersedes it.
    retier_interval: int = 8


@dataclasses.dataclass
class RebalanceConfig:
    """Telemetry-driven live rebalancer knobs (``[rebalance]``;
    rebalance/planner.py + rebalance/migrator.py — no reference analog:
    GoWorld's LBC heap only places NEW entities; this moves LIVE ones)."""

    # Master switch: when off, dispatchers collect load reports (the LBC
    # heap still uses them) but never plan migrations.
    enabled: bool = False
    # Which dispatcher runs the planner (exactly one must drive, and
    # dispatchers do not talk to each other; every dispatcher receives the
    # same load reports, so any id works — pick one).
    driver_dispatcher: int = 1
    # Seconds between planning rounds.
    interval: float = 1.0
    # Seconds between per-game load reports (game-side send cadence).
    report_interval: float = 1.0
    # Pause planning when any connected game's report is older than this
    # (stale telemetry must pause the rebalancer, never steer it).
    stale_after: float = 3.0
    # Hysteresis: plan moves only while donor.entities - receiver.entities
    # is at least this (prevents thrash around the balanced point).
    min_entity_delta: int = 4
    # Cap on entities moved per planning round (convergence is staged so a
    # plan never outruns the load reports that justify it).
    max_moves_per_round: int = 4
    # Game-side deadline per migration: past it the migrator cancels
    # (CANCEL_MIGRATE) and the entity stays where it was (rolled back).
    migrate_timeout: float = 5.0
    # Seconds a just-moved (or just-rolled-back) entity is exempt from
    # re-selection; doubles per consecutive rollback of the same entity.
    cooldown: float = 5.0
    # Cap on WHOLE-SPACE handoffs per planning round. 0 keeps
    # the planner entity-granular: a donor space whose kind has no
    # receiver-side twin simply stays put. Nonzero lets the bin-packer
    # move the space itself through the two-phase SPACE_MIGRATE protocol.
    max_space_moves_per_round: int = 0
    # Host the planner in the sharded RebalancePlannerService entity
    # instead of the driver dispatcher: the planner then fails over with
    # the service plane (a dead host's shard is re-claimed by a surviving
    # game and planning resumes from fresh GAME_LOAD_REPORT state).
    planner_service: bool = False


@dataclasses.dataclass
class ClientConfig:
    """Client/bot-side knobs (``[client]``)."""

    # Strict-bot per-RPC completion budget in seconds (bot_runner.py; the
    # reference hardcodes 5 s, ClientEntity.go:160-242). Reload windows on
    # slow rigs can legitimately exceed 5 s — widen this honestly instead
    # of eating a strict-mode flake.
    rpc_timeout: float = 5.0


@dataclasses.dataclass
class TelemetryConfig:
    """Distributed-tracing / flight-recorder knobs (``[telemetry]``;
    defaults mirror consts.py — telemetry/tracing.py)."""

    # Head-sampling denominator: 1-in-N ingress events start a trace
    # (0 disables tracing; 1 traces everything — test/debug only).
    trace_sample_rate: int = 1024
    # Finished-span ring size per process (drop-oldest).
    trace_ring_size: int = 4096
    # Game ticks busier than this many seconds trigger a flight-recorder
    # dump (ONE structured WARN + GET /flight); 0 disables the dump.
    slow_tick_budget: float = 0.1
    # How many tick records the flight recorder keeps.
    flight_ring_size: int = 240
    # Cluster observability plane (telemetry/collector.py): the driver
    # dispatcher scrapes every configured http_addr's /snapshot at this
    # cadence and serves the aggregate as GET /cluster (gwtop's source).
    # 0 disables the collector.
    cluster_snapshot_interval: float = 1.0
    # Device-runtime sentinel (telemetry/sentinel.py): launches after
    # which a fresh XLA trace of an engine step jit counts as a
    # steady-state retrace (jit_retrace_events_total + ONE structured
    # WARN naming the arg shape/dtype delta).
    retrace_warm_ticks: int = 32
    # Crash-survivable history ring (telemetry/history.py): when
    # history_dir is non-empty every process appends periodic telemetry
    # frames to <history_dir>/<process-name>/ — the per-process black box
    # post-mortem bundles collect. Empty = off (the default).
    history_dir: str = ""
    # Seconds between history frames (the writer rides its own asyncio
    # cadence task, never the logic loop).
    history_interval: float = 1.0
    # On-disk ring geometry: fixed-size segments, drop-oldest. Disk use
    # is bounded by history_segments * history_segment_bytes per process.
    history_segment_bytes: int = 262144
    history_segments: int = 8


@dataclasses.dataclass
class SLOConfig:
    """Cluster SLO budgets (``[slo]``; telemetry/slo.py). Budgets left
    unset (None) are not evaluated; ``enabled()`` is true when any budget
    is set. The driver dispatcher's ClusterCollector judges every poll
    against these and publishes per-budget compliance + multi-window burn
    rate in ``GET /cluster`` (gwtop's SLO column); ``run_scenario`` and
    the chaos harness accept the same object as a hard gate."""

    # Game tick p99 wall-clock budget, seconds (game_tick_phase_seconds
    # {phase=total} — the flight recorder's tick).
    tick_p99_budget: Optional[float] = None
    # Client delivery p99 budget, seconds: the sync_send phase p99 — the
    # slice of the tick spent fanning updates out to gates/clients.
    delivery_p99_budget: Optional[float] = None
    # Max tolerated strict-bot error rate (errors per bot), chaos/bench
    # gates only — there is no cluster-side metric for bot errors.
    bot_error_rate: Optional[float] = None
    # Max tolerated steady-state retraces, cluster-wide (the floor gates
    # pin 0; None = don't judge).
    steady_state_retraces: Optional[int] = None
    # Fraction of polls allowed out of budget before burn rate hits 1.0
    # (SRE error-budget convention: burn = violation_rate/error_budget).
    error_budget: float = 0.01
    # Burn-rate windows, in collector polls (short ≈ page-now, long ≈
    # budget-trend; 12/120 polls at the default 1 s cadence).
    burn_short_polls: int = 12
    burn_long_polls: int = 120

    def enabled(self) -> bool:
        return any(v is not None for v in (
            self.tick_p99_budget, self.delivery_p99_budget,
            self.bot_error_rate, self.steady_state_retraces))


@dataclasses.dataclass
class ScenarioConfig:
    """Scenario-matrix runner knobs (``[scenario]``; goworld_tpu_torch/
    scenarios/).  These parameterize DEVELOPMENT runs only — bench.py's
    gate mode always passes the registry's fixed config + seed so
    committed floors never drift with an operator's ini."""

    # Seed for ad-hoc scenario runs (the registry's per-scenario fixed
    # seed is used when < 0).
    seed: int = -1
    # Engine ad-hoc runs default to: batched | sharded.
    default_engine: str = "batched"
    # Multiplier on each scenario's tick count for ad-hoc soak/smoke
    # runs (1.0 = the registered length; floors always use 1.0).
    ticks_scale: float = 1.0


@dataclasses.dataclass
class LogConfig:
    """Process-wide logging knobs (``[log]``)."""

    # "text" = the zap-parity line format (default); "json" = one JSON
    # object per line with level/ts/source and automatic trace_id
    # injection inside active trace spans (utils/gwlog.py).
    format: str = "text"


@dataclasses.dataclass
class DebugConfig:
    debug: bool = False


@dataclasses.dataclass
class GoWorldConfig:
    deployment: DeploymentConfig = dataclasses.field(default_factory=DeploymentConfig)
    dispatchers: dict[int, DispatcherConfig] = dataclasses.field(default_factory=dict)
    games: dict[int, GameConfig] = dataclasses.field(default_factory=dict)
    gates: dict[int, GateConfig] = dataclasses.field(default_factory=dict)
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    kvdb: KVDBConfig = dataclasses.field(default_factory=KVDBConfig)
    aoi: AOIConfig = dataclasses.field(default_factory=AOIConfig)
    entity: EntityConfig = dataclasses.field(default_factory=EntityConfig)
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)
    sync: SyncConfig = dataclasses.field(default_factory=SyncConfig)
    rebalance: RebalanceConfig = dataclasses.field(default_factory=RebalanceConfig)
    client: ClientConfig = dataclasses.field(default_factory=ClientConfig)
    telemetry: TelemetryConfig = dataclasses.field(default_factory=TelemetryConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    scenario: ScenarioConfig = dataclasses.field(default_factory=ScenarioConfig)
    log: LogConfig = dataclasses.field(default_factory=LogConfig)
    debug: DebugConfig = dataclasses.field(default_factory=DebugConfig)


_lock = threading.Lock()
_config_file: Optional[str] = None
_config: Optional[GoWorldConfig] = None


def set_config_file(path: str) -> None:
    global _config_file, _config
    with _lock:
        _config_file = path
        _config = None


def set_config(cfg: GoWorldConfig) -> None:
    """Inject a config object directly (tests / embedded clusters)."""
    global _config
    with _lock:
        _config = cfg


def get() -> GoWorldConfig:
    global _config
    with _lock:
        if _config is None:
            _config = _load(_config_file)
        return _config


def reload() -> GoWorldConfig:
    global _config
    with _lock:
        _config = _load(_config_file)
        return _config


def _read_start_nodes(section) -> list:
    """``start_nodes_1 = host:port`` etc, sorted by numeric suffix for
    determinism (reference read_config.go:492-493 collects them into a
    StringSet; non-numeric suffixes sort after, lexicographically)."""
    nodes = []
    for name in section:
        if name.startswith("start_nodes_") and section[name].strip():
            suffix = name[len("start_nodes_"):]
            key = (0, int(suffix), "") if suffix.isdigit() else (1, 0, suffix)
            nodes.append((key, section[name].strip()))
    return [v for _, v in sorted(nodes)]


def _load(path: Optional[str]) -> GoWorldConfig:
    # Inline `;` comments, like the reference's go-ini (read_config.go:20).
    cp = configparser.ConfigParser(inline_comment_prefixes=(";",))
    if path is not None:
        read = cp.read(path)
        if not read:
            raise FileNotFoundError(f"config file not found: {path}")
    else:
        cp.read(DEFAULT_CONFIG_FILES)

    cfg = GoWorldConfig()

    if cp.has_section("deployment"):
        s = cp["deployment"]
        cfg.deployment = DeploymentConfig(
            desired_games=s.getint("games", 1),
            desired_gates=s.getint("gates", 1),
            desired_dispatchers=s.getint("dispatchers", 1),
        )

    def merged(section: str, common: str) -> dict[str, str]:
        out: dict[str, str] = {}
        if cp.has_section(common):
            out.update(cp[common])
        if cp.has_section(section):
            out.update(cp[section])
        return out

    for i in range(1, cfg.deployment.desired_dispatchers + 1):
        s = merged(f"dispatcher{i}", "dispatcher_common")
        cfg.dispatchers[i] = DispatcherConfig(
            host=s.get("host", "127.0.0.1"),
            port=int(s.get("port", 14000 + i)),
            http_addr=s.get("http_addr", ""),
            log_file=s.get("log_file", ""),
            log_level=s.get("log_level", "info"),
        )

    for i in range(1, cfg.deployment.desired_games + 1):
        s = merged(f"game{i}", "game_common")
        cfg.games[i] = GameConfig(
            boot_entity=s.get("boot_entity", ""),
            save_interval=float(s.get("save_interval", 300)),
            http_addr=s.get("http_addr", ""),
            log_file=s.get("log_file", ""),
            log_level=s.get("log_level", "info"),
            position_sync_interval=float(s.get("position_sync_interval", 0.1)),
            aoi_platform=s.get("aoi_platform", "").strip().lower(),
        )

    for i in range(1, cfg.deployment.desired_gates + 1):
        s = merged(f"gate{i}", "gate_common")
        cfg.gates[i] = GateConfig(
            host=s.get("host", "127.0.0.1"),
            port=int(s.get("port", 15000 + i)),
            ws_addr=s.get("ws_addr", ""),
            http_addr=s.get("http_addr", ""),
            log_file=s.get("log_file", ""),
            log_level=s.get("log_level", "info"),
            compress_connection=s.get("compress_connection", "false").lower() in ("1", "true", "yes"),
            compress_format=s.get("compress_format", "snappy").strip().lower(),
            rudp_protocol=s.get("rudp_protocol", "kcp").strip().lower(),
            rudp_fec=s.get("rudp_fec", "10,3").strip().lower(),
            encrypt_connection=s.get("encrypt_connection", "false").lower() in ("1", "true", "yes"),
            rsa_key=s.get("rsa_key", ""),
            rsa_cert=s.get("rsa_cert", ""),
            heartbeat_timeout=float(s.get("heartbeat_timeout", 30)),
            position_sync_interval=float(s.get("position_sync_interval", 0.1)),
        )

    if cp.has_section("storage"):
        s = cp["storage"]
        cfg.storage = StorageConfig(
            type=s.get("type", "filesystem"),
            directory=s.get("directory", "_entity_storage"),
            url=s.get("url", ""),
            db=s.get("db", "goworld"),
            start_nodes=_read_start_nodes(s),
            retry_base_interval=float(s.get("retry_base_interval", 1.0)),
            retry_max_interval=float(s.get("retry_max_interval", 30.0)),
            circuit_failure_threshold=int(
                s.get("circuit_failure_threshold", 5)),
            circuit_cooldown=float(s.get("circuit_cooldown", 5.0)),
            deferred_bytes_cap=int(
                s.get("deferred_bytes_cap", 8 * 1024 * 1024)),
        )
    if cp.has_section("kvdb"):
        s = cp["kvdb"]
        cfg.kvdb = KVDBConfig(
            type=s.get("type", "filesystem"),
            directory=s.get("directory", "_kvdb"),
            url=s.get("url", ""),
            db=s.get("db", "goworld"),
            collection=s.get("collection", "kvdb"),
            start_nodes=_read_start_nodes(s),
        )
    if cp.has_section("aoi"):
        s = cp["aoi"]
        cfg.aoi = AOIConfig(
            backend=s.get("backend", "auto").strip().lower(),
            platform=s.get("platform", "auto").strip().lower(),
            cell_capacity=int(s.get("cell_capacity", 64)),
            max_entities=int(s.get("max_entities", 16384)),
            mesh_shards=int(s.get("mesh_shards", 1)),
            shard_mode=s.get("shard_mode", "spatial").strip().lower(),
            strip_placement=s.get(
                "strip_placement", "topology").strip().lower(),
            pallas_strip_cols=int(s.get("pallas_strip_cols", 0)),
            pallas_inkernel_drain=s.get(
                "pallas_inkernel_drain", "true").strip().lower()
            in ("1", "true", "yes"),
            compilation_cache=s.get("compilation_cache", "auto").strip(),
            grid=int(s.get("grid", 0)),
            cell_size=float(s.get("cell_size", 0.0)),
            space_slots=int(s.get("space_slots", 0)),
            multihost_coordinator=s.get("multihost_coordinator", "").strip(),
            multihost_processes=int(s.get("multihost_processes", 0)),
            delivery=s.get("delivery", "pipelined").strip().lower(),
            sync_wait_budget=float(s.get("sync_wait_budget", 0.5)),
            fuse_logic=s.get("fuse_logic", "false").strip().lower()
            in ("1", "true", "yes"),
        )
    if cp.has_section("cluster"):
        s = cp["cluster"]
        cfg.cluster = ClusterConfig(
            down_buffer_bytes=int(s.get("down_buffer_bytes", 2 * 1024 * 1024)),
            peer_heartbeat_timeout=float(s.get("peer_heartbeat_timeout", 10.0)),
            wait_connected_timeout=float(s.get("wait_connected_timeout", 10.0)),
            reconnect_max_interval=float(s.get("reconnect_max_interval", 15.0)),
            transport=s.get("transport", "tcp").strip().lower(),
            uds_dir=s.get("uds_dir", "").strip(),
            sync_flush_bytes=int(s.get("sync_flush_bytes", 32 * 1024)),
        )
    if cp.has_section("entity"):
        cfg.entity = EntityConfig(
            slab_initial=int(cp["entity"].get("slab_initial", 256)),
        )
    if cp.has_section("sync"):
        s = cp["sync"]
        cfg.sync = SyncConfig(
            tier_cadences=tuple(
                int(v) for v in
                s.get("tier_cadences", "1").replace(" ", "").split(",")
                if v),
            quantize_bits=int(s.get("quantize_bits", 0)),
            keyframe_interval=int(s.get("keyframe_interval", 32)),
            near_ratio=float(s.get("near_ratio", 0.5)),
            far_ratio=float(s.get("far_ratio", 0.8)),
            retier_interval=int(s.get("retier_interval", 8)),
        )
    if cp.has_section("rebalance"):
        s = cp["rebalance"]
        cfg.rebalance = RebalanceConfig(
            enabled=s.get("enabled", "false").lower() in ("1", "true", "yes"),
            driver_dispatcher=int(s.get("driver_dispatcher", 1)),
            interval=float(s.get("interval", 1.0)),
            report_interval=float(s.get("report_interval", 1.0)),
            stale_after=float(s.get("stale_after", 3.0)),
            min_entity_delta=int(s.get("min_entity_delta", 4)),
            max_moves_per_round=int(s.get("max_moves_per_round", 4)),
            migrate_timeout=float(s.get("migrate_timeout", 5.0)),
            cooldown=float(s.get("cooldown", 5.0)),
            max_space_moves_per_round=int(
                s.get("max_space_moves_per_round", 0)),
            planner_service=s.get("planner_service", "false").lower()
            in ("1", "true", "yes"),
        )
    if cp.has_section("client"):
        cfg.client = ClientConfig(
            rpc_timeout=float(cp["client"].get("rpc_timeout", 5.0)),
        )
    if cp.has_section("telemetry"):
        s = cp["telemetry"]
        cfg.telemetry = TelemetryConfig(
            trace_sample_rate=int(s.get("trace_sample_rate", 1024)),
            trace_ring_size=int(s.get("trace_ring_size", 4096)),
            slow_tick_budget=float(s.get("slow_tick_budget", 0.1)),
            flight_ring_size=int(s.get("flight_ring_size", 240)),
            cluster_snapshot_interval=float(
                s.get("cluster_snapshot_interval", 1.0)),
            retrace_warm_ticks=int(s.get("retrace_warm_ticks", 32)),
            history_dir=s.get("history_dir", "").strip(),
            history_interval=float(s.get("history_interval", 1.0)),
            history_segment_bytes=int(s.get("history_segment_bytes", 262144)),
            history_segments=int(s.get("history_segments", 8)),
        )
    if cp.has_section("slo"):
        s = cp["slo"]

        def _opt_f(v):
            v = v.strip()
            return float(v) if v else None  # "" = budget unset

        retr = s.get("steady_state_retraces", "").strip()
        cfg.slo = SLOConfig(
            tick_p99_budget=_opt_f(s.get("tick_p99_budget", "")),
            delivery_p99_budget=_opt_f(s.get("delivery_p99_budget", "")),
            bot_error_rate=_opt_f(s.get("bot_error_rate", "")),
            steady_state_retraces=int(retr) if retr else None,
            error_budget=float(s.get("error_budget", 0.01)),
            burn_short_polls=int(s.get("burn_short_polls", 12)),
            burn_long_polls=int(s.get("burn_long_polls", 120)),
        )
    if cp.has_section("scenario"):
        s = cp["scenario"]
        cfg.scenario = ScenarioConfig(
            seed=int(s.get("seed", -1)),
            default_engine=s.get("default_engine", "batched"),
            ticks_scale=float(s.get("ticks_scale", 1.0)),
        )
    if cp.has_section("log"):
        cfg.log = LogConfig(
            format=cp["log"].get("format", "text").strip().lower(),
        )
    if cp.has_section("debug"):
        cfg.debug = DebugConfig(debug=cp["debug"].getboolean("debug", False))

    _validate(cfg)
    return cfg


def parse_fec(spec: str, gid=None) -> tuple[int, int] | None:
    """"data,parity" → (d, p); "off" → None; anything else raises."""
    if spec == "off":
        return None
    where = f"gate{gid}: " if gid is not None else ""
    try:
        d_s, p_s = spec.split(",")
        d, p = int(d_s), int(p_s)
    except ValueError:
        raise ValueError(
            f"{where}rudp_fec must be 'data,parity' or 'off', got {spec!r}"
        ) from None
    if not (1 <= d <= 128 and 1 <= p <= 128):
        raise ValueError(f"{where}rudp_fec shards must be in [1, 128]")
    if d + p > 255:
        # GF(2^8) Vandermonde rows repeat at alpha^255 = 1: a 256-shard
        # code silently degenerates (duplicate rows → singular subsets).
        raise ValueError(f"{where}rudp_fec data+parity must be <= 255")
    return d, p


def _validate(cfg: GoWorldConfig) -> None:
    """Sanity checks, mirroring read_config.go:538-661."""
    if cfg.aoi.backend not in ("auto", "xzlist", "tpu"):
        raise ValueError(
            f"[aoi] backend must be auto|xzlist|tpu, got {cfg.aoi.backend!r}"
        )
    if cfg.aoi.platform not in ("auto", "cpu", "cuda"):
        # A typo here would silently put a CPU-deploy game on the card
        # (GameService only acts on the exact value "cpu") — fail loudly.
        # "tpu" is the JAX package's spelling of the accelerator.
        raise ValueError(
            f"[aoi] platform must be auto|cpu|cuda (auto = the CUDA "
            f"card), got {cfg.aoi.platform!r}"
        )
    a = cfg.aoi
    if a.max_entities < 8:
        raise ValueError("[aoi] max_entities must be >= 8")
    if not (1 <= a.cell_capacity <= 128):
        raise ValueError("[aoi] cell_capacity must be in [1, 128]")
    if a.mesh_shards < 1:
        raise ValueError("[aoi] mesh_shards must be >= 1")
    if a.shard_mode not in ("spatial", "entity"):
        raise ValueError("[aoi] shard_mode must be spatial or entity")
    if a.strip_placement not in ("topology", "ring"):
        raise ValueError(
            f"[aoi] strip_placement must be topology or ring, "
            f"got {a.strip_placement!r}"
        )
    if a.pallas_strip_cols < 0:
        # Negative would silently disable the width cap the Pallas slab's
        # static extent depends on — reject loudly (0 = derive).
        raise ValueError(
            "[aoi] pallas_strip_cols must be >= 0 (0 = derive)")
    if not a.compilation_cache:
        raise ValueError(
            "[aoi] compilation_cache must be auto, off, or a directory")
    if a.grid != 0 and not (4 <= a.grid <= 512):
        raise ValueError("[aoi] grid must be 0 (derive) or in [4, 512]")
    if a.cell_size < 0.0:
        # A negative cell size would bin every entity into garbage cells
        # and silently return wrong neighbor sets.
        raise ValueError("[aoi] cell_size must be >= 0 (0 = default)")
    if a.space_slots < 0:
        raise ValueError("[aoi] space_slots must be >= 0 (0 = default)")
    if a.delivery not in ("pipelined", "sync"):
        raise ValueError(
            f"[aoi] delivery must be pipelined|sync, got {a.delivery!r}"
        )
    if a.sync_wait_budget <= 0:
        # 0 would park every sync step unconditionally (sync mode that
        # never delivers same-tick); negative is nonsense.
        raise ValueError("[aoi] sync_wait_budget must be > 0 seconds")
    if a.delivery == "sync" and a.multihost_coordinator:
        # Sync delivery stalls the loop inside device collectives; on the
        # DCN tier a dead peer would turn that stall into a permanent
        # wedge of every survivor's logic loop AND defeat the freeze
        # flush's liveness bound (code-review r5). The multihost tier is
        # pipelined by design — frame-skipping keeps a dead peer
        # degraded-but-live.
        raise ValueError(
            "[aoi] delivery = sync is incompatible with "
            "multihost_coordinator (a dead peer would wedge every "
            "survivor's logic loop inside a collective); use pipelined"
        )
    for gid, g in cfg.gates.items():
        if g.compress_format not in ("snappy", "zlib"):
            raise ValueError(
                f"gate{gid}: compress_format must be snappy|zlib, "
                f"got {g.compress_format!r}"
            )
        if g.rudp_protocol not in ("kcp", "native"):
            raise ValueError(
                f"gate{gid}: rudp_protocol must be kcp|native, "
                f"got {g.rudp_protocol!r}"
            )
        parse_fec(g.rudp_fec, gid)  # raises on malformed spec
    for gid, g in cfg.games.items():
        if g.aoi_platform not in ("", "auto", "cpu", "cuda"):
            raise ValueError(
                f"game{gid}: aoi_platform must be auto|cpu|cuda (auto = "
                f"the CUDA card), got {g.aoi_platform!r}"
            )
    if a.multihost_coordinator:
        if a.backend == "xzlist":
            raise ValueError(
                "[aoi] multihost_coordinator requires the batched backend "
                "(backend = tpu or auto), not xzlist"
            )
        if a.mesh_shards > 1:
            raise ValueError(
                "[aoi] multihost_coordinator and mesh_shards > 1 are "
                "mutually exclusive (single-host ICI tier vs multi-host "
                "DCN tier)"
            )
        nproc = a.multihost_processes or len(cfg.games)
        if nproc < 2:
            raise ValueError(
                "[aoi] multihost needs >= 2 processes (games); for one "
                "process use mesh_shards instead"
            )
        if a.multihost_processes and a.multihost_processes != len(cfg.games):
            raise ValueError(
                f"[aoi] multihost_processes ({a.multihost_processes}) must "
                f"match the number of games ({len(cfg.games)}) — every game "
                f"joins the mesh"
            )
        plats = {
            (g.aoi_platform or a.platform) for g in cfg.games.values()
        }
        if len(plats) > 1:
            raise ValueError(
                "[aoi] multihost requires every game on the SAME jax "
                f"platform (one global mesh); got {sorted(plats)}"
            )
        cadences = {g.position_sync_interval for g in cfg.games.values()}
        if len(cadences) > 1:
            # Dispatches are readiness-gated so differing cadences cannot
            # diverge the global op sequence, but the slowest game would
            # silently pace every other game's AOI — surprising enough to
            # reject outright.
            raise ValueError(
                "[aoi] multihost requires the same position_sync_interval "
                f"on every game; got {sorted(cadences)}"
            )
    cl = cfg.cluster
    if cl.down_buffer_bytes < 0:
        raise ValueError("[cluster] down_buffer_bytes must be >= 0 (0 = drop)")
    if cl.peer_heartbeat_timeout < 0:
        raise ValueError(
            "[cluster] peer_heartbeat_timeout must be >= 0 (0 = disabled)")
    if cl.wait_connected_timeout <= 0:
        raise ValueError("[cluster] wait_connected_timeout must be > 0")
    if cl.reconnect_max_interval <= 0:
        raise ValueError("[cluster] reconnect_max_interval must be > 0")
    if cl.transport not in ("tcp", "uds"):
        # A typo here would leave games dialing TCP while the operator
        # believes the cluster rides unix sockets — fail loudly.
        raise ValueError(
            f"[cluster] transport must be tcp|uds, got {cl.transport!r}")
    if cl.sync_flush_bytes < 0:
        raise ValueError(
            "[cluster] sync_flush_bytes must be >= 0 (0 = tick-only flush)")
    sy = cfg.sync
    if not sy.tier_cadences or sy.tier_cadences[0] != 1:
        # Tier 0 is the full-rate tier by contract: new/near pairs land
        # there, so a first cadence != 1 would throttle EVERY pair.
        raise ValueError(
            "[sync] tier_cadences must be a non-empty ascending list "
            "starting at 1 (tier 0 = full rate), got "
            f"{list(sy.tier_cadences)}")
    if any(b <= a for a, b in zip(sy.tier_cadences, sy.tier_cadences[1:])):
        raise ValueError(
            "[sync] tier_cadences must be strictly ascending, got "
            f"{list(sy.tier_cadences)}")
    if any(c > 1024 for c in sy.tier_cadences):
        raise ValueError("[sync] tier cadences above 1024 would stall "
                         "distant pairs for tens of seconds")
    if not 0 <= sy.quantize_bits <= 14:
        # 15+ fractional bits leave the int16 delta range below one world
        # unit — any real movement would force a keyframe every record.
        raise ValueError(
            f"[sync] quantize_bits must be in [0, 14], got "
            f"{sy.quantize_bits}")
    if sy.keyframe_interval < 2:
        raise ValueError("[sync] keyframe_interval must be >= 2 "
                         "collections (1 would disable deltas implicitly)")
    if not 0.0 < sy.near_ratio < sy.far_ratio <= 1.0:
        raise ValueError(
            "[sync] requires 0 < near_ratio < far_ratio <= 1.0, got "
            f"near_ratio={sy.near_ratio} far_ratio={sy.far_ratio}")
    if sy.retier_interval < 1:
        raise ValueError("[sync] retier_interval must be >= 1")
    rb = cfg.rebalance
    if rb.driver_dispatcher < 1:
        raise ValueError("[rebalance] driver_dispatcher must be >= 1")
    if rb.enabled and rb.driver_dispatcher not in cfg.dispatchers \
            and cfg.dispatchers:
        # A driver id naming no configured dispatcher means NO dispatcher
        # ever plans — the operator believes rebalancing is on while it is
        # silently dead. Fail loudly.
        raise ValueError(
            f"[rebalance] driver_dispatcher = {rb.driver_dispatcher} names "
            f"no configured dispatcher (have {sorted(cfg.dispatchers)})")
    if rb.interval <= 0 or rb.report_interval <= 0:
        raise ValueError(
            "[rebalance] interval and report_interval must be > 0 seconds")
    if rb.stale_after < rb.report_interval:
        # A staleness window shorter than the report cadence pauses the
        # planner permanently between perfectly healthy reports.
        raise ValueError(
            "[rebalance] stale_after must be >= report_interval")
    if rb.min_entity_delta < 1:
        raise ValueError("[rebalance] min_entity_delta must be >= 1")
    if rb.max_moves_per_round < 1:
        raise ValueError("[rebalance] max_moves_per_round must be >= 1")
    if rb.migrate_timeout <= 0:
        raise ValueError("[rebalance] migrate_timeout must be > 0 seconds")
    if rb.cooldown < 0:
        raise ValueError("[rebalance] cooldown must be >= 0 seconds")
    if rb.max_space_moves_per_round < 0:
        raise ValueError(
            "[rebalance] max_space_moves_per_round must be >= 0 "
            "(0 = whole-space moves disabled)")
    if cfg.client.rpc_timeout <= 0:
        raise ValueError("[client] rpc_timeout must be > 0 seconds")
    t = cfg.telemetry
    if t.trace_sample_rate < 0:
        raise ValueError(
            "[telemetry] trace_sample_rate must be >= 0 (0 = off, N = 1/N)")
    if t.trace_ring_size < 1:
        raise ValueError("[telemetry] trace_ring_size must be >= 1")
    if t.slow_tick_budget < 0:
        raise ValueError(
            "[telemetry] slow_tick_budget must be >= 0 (0 = no slow dumps)")
    if t.flight_ring_size < 1:
        raise ValueError("[telemetry] flight_ring_size must be >= 1")
    if t.cluster_snapshot_interval < 0:
        raise ValueError(
            "[telemetry] cluster_snapshot_interval must be >= 0 seconds "
            "(0 = no cluster collector)")
    if t.retrace_warm_ticks < 1:
        raise ValueError("[telemetry] retrace_warm_ticks must be >= 1")
    if t.history_interval <= 0:
        raise ValueError("[telemetry] history_interval must be > 0 seconds")
    if t.history_segment_bytes < 4096:
        raise ValueError(
            "[telemetry] history_segment_bytes must be >= 4096")
    if t.history_segments < 2:
        raise ValueError(
            "[telemetry] history_segments must be >= 2 (the ring needs a "
            "previous segment to survive rotation)")
    slo = cfg.slo
    for key, v in (("tick_p99_budget", slo.tick_p99_budget),
                   ("delivery_p99_budget", slo.delivery_p99_budget),
                   ("bot_error_rate", slo.bot_error_rate)):
        if v is not None and v < 0:
            raise ValueError(f"[slo] {key} must be >= 0")
    if slo.steady_state_retraces is not None and slo.steady_state_retraces < 0:
        raise ValueError("[slo] steady_state_retraces must be >= 0")
    if not (0.0 < slo.error_budget <= 1.0):
        raise ValueError("[slo] error_budget must be in (0, 1]")
    if slo.burn_short_polls < 1 or slo.burn_long_polls < slo.burn_short_polls:
        raise ValueError(
            "[slo] burn windows must satisfy 1 <= burn_short_polls "
            "<= burn_long_polls")
    sc = cfg.scenario
    if sc.default_engine not in ("batched", "sharded"):
        raise ValueError(
            f"[scenario] default_engine must be batched|sharded, "
            f"got {sc.default_engine!r}")
    if not (0.0 < sc.ticks_scale <= 100.0):
        raise ValueError(
            "[scenario] ticks_scale must be in (0, 100]")
    if cfg.log.format not in ("text", "json"):
        raise ValueError(
            f"[log] format must be text|json, got {cfg.log.format!r}")
    st = cfg.storage
    if st.retry_base_interval <= 0 or st.retry_max_interval <= 0:
        raise ValueError("[storage] retry intervals must be > 0 seconds")
    if st.retry_max_interval < st.retry_base_interval:
        raise ValueError(
            "[storage] retry_max_interval must be >= retry_base_interval")
    if st.circuit_failure_threshold < 1:
        # 0 would open the circuit before the first attempt — saves would
        # never reach the backend at all.
        raise ValueError("[storage] circuit_failure_threshold must be >= 1")
    if st.circuit_cooldown <= 0:
        raise ValueError("[storage] circuit_cooldown must be > 0 seconds")
    if st.deferred_bytes_cap < 0:
        raise ValueError("[storage] deferred_bytes_cap must be >= 0")
    for section, c in (("storage", cfg.storage), ("kvdb", cfg.kvdb)):
        if c.type == "redis_cluster" and not c.start_nodes:
            # read_config.go:555-556,617-619: fatal without seed nodes.
            raise ValueError(
                f"must have at least 1 start_nodes for [{section}].redis_cluster"
            )
    if cfg.deployment.desired_dispatchers < 1:
        raise ValueError("deployment.dispatchers must be >= 1")
    if cfg.deployment.desired_games < 1:
        raise ValueError("deployment.games must be >= 1")
    seen: dict[tuple[str, int], str] = {}
    for did, d in cfg.dispatchers.items():
        key = (d.host, d.port)
        if key in seen:
            raise ValueError(f"dispatcher{did} addr {key} duplicates {seen[key]}")
        seen[key] = f"dispatcher{did}"
    for gid, g in cfg.gates.items():
        key = (g.host, g.port)
        if key in seen:
            raise ValueError(f"gate{gid} addr {key} duplicates {seen[key]}")
        seen[key] = f"gate{gid}"
        if g.encrypt_connection and not (g.rsa_key and g.rsa_cert):
            raise ValueError(f"gate{gid}: encrypt_connection requires rsa_key and rsa_cert")


# --- typed accessors (reference read_config.go:178-214) ---------------------

def get_deployment() -> DeploymentConfig:
    return get().deployment


def get_game(gameid: int) -> GameConfig:
    return get().games[gameid]


def get_gate(gateid: int) -> GateConfig:
    return get().gates[gateid]


def get_dispatcher(dispid: int) -> DispatcherConfig:
    return get().dispatchers[dispid]


def get_game_ids() -> list[int]:
    return sorted(get().games)


def get_gate_ids() -> list[int]:
    return sorted(get().gates)


def get_dispatcher_ids() -> list[int]:
    return sorted(get().dispatchers)


def get_storage() -> StorageConfig:
    return get().storage


def get_kvdb() -> KVDBConfig:
    return get().kvdb
