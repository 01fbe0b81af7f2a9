"""Ingress gateway: the session-oriented front door for 10k+ clients.

The commit pipeline behind the fuse window sustains hundreds of
thousands of durable tps, but a production ledger's first pipeline
stage is the NETWORK path ("Blockchain Machine" treats ingress as the
accelerator's stage 0) — and a front door sized for a dozen bench
sessions falls over at the first connect storm. This package is the
gateway layer between the transport and the replica:

- `gateway.IngressGateway`: the per-replica admission front door. It
  wraps the replica's message handler, tracks LOGICAL sessions (many
  sessions multiplex over one TCP connection — the bus aliases reply
  routing per client id, the gateway tracks per-session request
  sequence), and answers requests the pipeline cannot absorb with a
  typed `Command.busy` reply instead of letting them queue unboundedly
  or drop silently. The replica never blocks on ingress; a shed client
  backs off and resends the same bytes.
- `regulator.CreditRegulator`: O(1) credit-based admission fed by the
  commit pipeline's occupancy (`Replica.ingress_occupancy`, the fuse
  window + async-commit backlog) and the bus `MessagePool` budget. One
  occupancy read mints a batch of credits equal to the free capacity;
  per-request admission is a decrement (AT2's per-client-state-tiny-
  enough-that-admission-is-O(1) argument).
- `fanout.CdcFanoutHub`: one CDC tail feeding N consumer cursors. Each
  consumer owns its position, cursor and sink; the shared live window
  releases at the SLOWEST consumer's position (bounded — beyond the
  window a laggard falls back to WAL/AOF reads), so a throttled
  consumer pauses only itself. Closes the PR-4 one-cursor-per-sink
  limitation.

Transport-level defenses (accept-drain behind a deep listen backlog,
per-connection dispatch budgets against firehose peers, bounded recv
per turn against slow-loris trickles, write-queue caps that disconnect
wedged consumers, pool credit on close) live in io/message_bus.py; the
gateway is the policy layer above them.
"""

from tigerbeetle_tpu_torch.ingress.fanout import CdcFanoutHub
from tigerbeetle_tpu_torch.ingress.gateway import IngressGateway
from tigerbeetle_tpu_torch.ingress.regulator import CreditRegulator

__all__ = ["CdcFanoutHub", "CreditRegulator", "IngressGateway"]
