"""The episode deal of a learner server whose ranks share one host.

``--train-server`` over a host's cards runs one rank per card
(:mod:`.launch`), but remote worker machines reach one endpoint: the
fixed entry and worker ports.  Rank 0 alone binds them and does what
must happen once per episode (the staleness budget, the WAL, the
generation and league stats, the chaos kill switch, the fleet's epoch
clock); it then deals each admitted episode to exactly one dp
coordinate of the mesh, round robin in admission order
(:func:`deal_ranks` of the episode's sequence number, the WAL's where
there is one, so a WAL replay deals every episode where it went live).
Batch rows shard over ``dp`` and replicate over ``sp`` and ``tp``, as
in the JAX package: every rank of a dp coordinate gets that
coordinate's episodes, and its first rank's rows are the ones the group
trains on (``multihost.share_rows``).  On a pure dp mesh that is one
rank per episode.  A follower only ingests what it is dealt, into its
own ring.

The deal travels on a channel of its own, never on a process group:
the trainer threads' collectives (the control word, the gradient
reductions) keep one order on every rank, and a server thread calling
into the same groups would interleave with them differently on
different ranks.  Each follower holds one framed connection
(:class:`~..connection.FramedConnection`) to a localhost port that rank
0 opens; the port crosses once at start-up on the control group
(:func:`open_channel`).  Rank 0 sends ``(verb, episodes)``:

  * ``replay``: a chunk of the follower's share of a WAL replay, which
    the follower stages on its main thread before its trainer starts;
    ``warm`` ends the replay (sent on every start, replay or none);
  * ``deal``: live episodes, ingested on the follower's feed thread;
  * ``end``: rank 0 closes the channel, after every episode it
    admitted, those drained after the last epoch included.

A channel that breaks any other way is :class:`ChannelBroken` on the
side that sees it (a send that waits past ``SEND_TIMEOUT`` on a wedged
follower, a feed whose ingest fails, included), and that rank leaves as
a dead rank: no episode is dropped quietly.
"""

import queue
import socket
import threading
import time

from ..connection import FramedConnection, open_socket_connection
from . import multihost as mh

ACCEPT_TIMEOUT = 120.0  # seconds rank 0 waits for every follower to dial
SEND_TIMEOUT = 60.0     # seconds a send to a follower may wait
REPLAY_CHUNK = 64       # episodes per ``replay`` message


class ChannelBroken(ConnectionError):
    """The episode channel between rank 0 and a follower broke."""


def deal_ranks(seq, dp, group=1):
    """The ranks that ingest the episode of sequence number ``seq``
    (1-based, in admission order) on a mesh of ``dp`` coordinates of
    ``group`` (``sp * tp``) ranks each, laid out dp major as
    ``make_mesh`` lays them: every rank of one coordinate, round robin
    over the coordinates from 0."""
    first = (int(seq) - 1) % dp * group
    return range(first, first + group)


def _group_size(world, dp):
    """Ranks per dp coordinate (``sp * tp``) of a ``world``-rank mesh."""
    if dp < 1 or world % dp:
        raise ValueError(f"a mesh of {world} ranks has no dp axis of {dp}")
    return world // dp


def open_channel(counts, dp):
    """Start-up on every rank of a one-host group of ``dp`` coordinates
    (collectives on the control group, then the dial): ``counts``
    summed over the first rank of each dp coordinate (the fleet's; the
    other ranks hold copies of their coordinate's ring), and this rank's
    end of the channel, an :class:`EpisodeDealer` on rank 0 or an
    :class:`EpisodeFeed`."""
    rank, world = mh.process_index(), mh.process_count()
    group = _group_size(world, dp)
    listener = None
    if rank == 0:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            listener.bind(("127.0.0.1", 0))
            listener.listen(world)
        except OSError:
            listener.close()
            raise
    try:
        port = mh.broadcast_int(
            listener.getsockname()[1] if listener is not None else 0)
        fleet = mh.sum_over_ranks(
            counts if rank % group == 0 else [0] * len(counts))
    except BaseException:
        if listener is not None:
            listener.close()
        raise
    if listener is not None:
        dealer = EpisodeDealer(world, dp)
        dealer.accept(listener, ACCEPT_TIMEOUT)
        return fleet, dealer
    return fleet, EpisodeFeed.dial(port, rank)


class EpisodeDealer:
    """Rank 0's end: one connection per follower; the deal's counts."""

    def __init__(self, world, dp=None):
        self.world = world
        self.dp = dp or world
        self.group = _group_size(world, self.dp)
        self.conns = {}
        self.seq = 0                  # the last sequence number dealt
        self.dealt = [0] * world      # live episodes per rank
        self.replayed = [0] * world   # WAL-replayed episodes per rank
        self.warmed = False

    def accept(self, listener, timeout):
        """Every follower dials and names its rank; the listener closes."""
        deadline = time.monotonic() + timeout
        try:
            while len(self.conns) < self.world - 1:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise socket.timeout()
                listener.settimeout(left)
                sock, _ = listener.accept()
                conn = FramedConnection(sock)
                conn.sock.settimeout(left)
                try:
                    rank = int(conn.recv())
                except (OSError, ValueError, TypeError):
                    conn.close()
                    raise
                # a follower that stops reading fails the send, not
                # rank 0's server thread
                conn.sock.settimeout(SEND_TIMEOUT)
                self.conns[rank] = conn
        except socket.timeout:
            self.close()
            raise ChannelBroken(
                f"episode channel: {len(self.conns)} of {self.world - 1} "
                f"follower rank(s) dialled within {timeout:.0f} s") from None
        finally:
            listener.close()

    def _shares(self, episodes, seqs):
        """Split ``episodes`` by rank; ``seqs`` are their sequence
        numbers (None: numbered on from the last one dealt)."""
        shares = [[] for _ in range(self.world)]
        for i, episode in enumerate(episodes):
            self.seq = seqs[i] if seqs is not None else self.seq + 1
            for rank in deal_ranks(self.seq, self.dp, self.group):
                shares[rank].append(episode)
        return shares

    def _send(self, rank, message):
        try:
            self.conns[rank].send(message)
        except OSError as exc:
            raise ChannelBroken(f"episode channel to rank {rank} broke "
                                f"({exc!r})") from exc

    def replay(self, episodes=(), seqs=()):
        """Deal a WAL replay (in sequence order), then ``warm`` to every
        follower; returns rank 0's share.  Called once, at start-up."""
        shares = self._shares(list(episodes), list(seqs))
        for rank in range(1, self.world):
            share = shares[rank]
            for i in range(0, len(share), REPLAY_CHUNK):
                self._send(rank, ("replay", share[i:i + REPLAY_CHUNK]))
            self._send(rank, ("warm", None))
        self.replayed = [len(share) for share in shares]
        self.warmed = True
        return shares[0]

    def deal(self, episodes, seqs=None):
        """Deal admitted episodes; returns rank 0's share."""
        shares = self._shares(episodes, seqs)
        for rank in range(1, self.world):
            if shares[rank]:
                self._send(rank, ("deal", shares[rank]))
        for rank, share in enumerate(shares):
            self.dealt[rank] += len(share)
        return shares[0]

    def close(self):
        """``end`` to every follower, then the connections close; a
        follower already gone is the launch's to report."""
        for rank in sorted(self.conns):
            conn = self.conns[rank]
            try:
                conn.send(("end", None))
            except OSError:
                pass
            finally:
                conn.close()
        self.conns = {}


class EpisodeFeed:
    """A follower's end: its share of the WAL replay at start-up, then
    its live deal on a thread of its own."""

    def __init__(self, conn):
        self.conn = conn
        self.received = 0        # live episodes dealt to this rank
        self.replayed = 0        # WAL-replayed episodes dealt to it
        self.finished = False    # rank 0 sent ``end``
        self.failure = None      # ChannelBroken once the channel broke
        self._thread = None

    @classmethod
    def dial(cls, port, rank):
        conn = open_socket_connection("127.0.0.1", port)
        try:
            conn.send(rank)
        except OSError as exc:
            conn.close()
            raise ChannelBroken(f"episode channel: rank {rank} could not "
                                f"name itself to rank 0 ({exc!r})") from exc
        return cls(conn)

    def _recv(self):
        try:
            # torchlint: disable=unbounded-recv -- rank 0 is this rank's peer in every collective: a dead rank 0 closes the socket (raises here), and a wedged one wedges the group, which the launch's supervision ends
            return self.conn.recv()
        except (OSError, EOFError) as exc:
            raise ChannelBroken(f"episode channel from rank 0 broke "
                                f"({exc!r})") from exc

    def warm(self):
        """This rank's share of rank 0's WAL replay, until ``warm``."""
        episodes = []
        while True:
            verb, payload = self._recv()
            if verb == "replay":
                episodes.extend(payload)
            elif verb == "warm":
                self.replayed = len(episodes)
                return episodes
            else:
                raise ChannelBroken(f"episode channel: {verb!r} before "
                                    "the end of the replay")

    def start(self, ingest):
        """Ingest the live deal on the feed thread until ``end``."""
        self._thread = threading.Thread(target=self._run, args=(ingest,),
                                        daemon=True, name="episode-feed")
        self._thread.start()

    def _run(self, ingest):
        try:
            while True:
                verb, payload = self._recv()
                if verb == "deal":
                    ingest(payload)
                    self.received += len(payload)
                elif verb == "end":
                    self.finished = True
                    return
                else:
                    raise ChannelBroken(f"episode channel: unexpected "
                                        f"{verb!r}")
        except ChannelBroken as exc:
            self.failure = exc
        except Exception as exc:
            # a frame that does not unpickle, an ingest that fails: the
            # feed is over either way, and its rank must say so
            broken = ChannelBroken(f"episode feed failed ({exc!r})")
            broken.__cause__ = exc
            self.failure = broken

    @property
    def open(self):
        return not (self.finished or self.failure is not None)

    def close(self):
        self.conn.close()


class FollowerEndpoint:
    """A follower's stand-in for the worker endpoint: no port and no
    peer (so no message, no stale peer, no reply), and the learner's
    server loop runs on it as on a ``WorkerServer`` no machine has
    joined; it counts one connection while the feed is open (the loop
    lasts until ``end``, so every episode rank 0 dealt lands) and
    raises the feed's failure."""

    liveness_hook = None

    def __init__(self, feed):
        self.feed = feed

    def run(self):
        pass

    def connection_count(self):
        return 1 if self.feed.open else 0

    def live_connections(self):
        return []

    def recv(self, timeout=None):
        if self.feed.failure is not None:
            raise self.feed.failure
        time.sleep(timeout or 0.0)
        raise queue.Empty

    def drop_stats(self):
        return {"send_drops": 0, "disconnects": 0, "unknown_verbs": 0}

    def fleet_stats(self):
        return self.drop_stats()

    def note_epoch(self, epoch):
        pass

    def begin_drain(self):
        pass

    def terminate_fleet(self):
        pass

    def shutdown(self):
        self.feed.close()
