"""Driver: avrecode_tpu_torch.parallel.distributed.corpus_compress in one
process, handed successive lists of the mix's files.

The pool names each output after its input's basename and sorts its list,
so each entry of a list is a symlink named by its place in the run
(<seq>_<file>) to the file under the run's working directory. A file is
complete when the pool has verified and written its container: its time
ends at the output's modification time and starts that many seconds
earlier as the pool's own record (CorpusReport.per_file) gives them.
"""
from __future__ import annotations

import os
import time

from harness.record import Record


class Driver:
    def __init__(self, config: dict, device: str, workdir: str):
        from avrecode_tpu_torch.parallel import distributed
        self.dist = distributed
        self.config = config
        self.device = device
        self.src = os.path.join(workdir, "src")
        self.lists = os.path.join(workdir, "in")
        self.out = os.path.join(workdir, "out")
        for d in (self.src, self.lists, self.out):
            os.makedirs(d, exist_ok=True)
        self.seq = 0
        self.calls: list = []   # (wall seconds, host workers, [per-file seconds])

    def _path(self, it) -> str:
        src = os.path.join(self.src, it.name)
        if not os.path.exists(src):
            with open(src, "wb") as f:
                f.write(it.data)
        link = os.path.join(self.lists, f"{self.seq:07d}_{it.name}")
        self.seq += 1
        os.symlink(src, link)
        return link

    def _pool(self, paths: list[str], out_dir: str):
        c = self.config
        return self.dist.corpus_compress(
            paths, out_dir, use_device=True, chunk_mode=c["chunk_mode"],
            batch_size=c["batch_size"], verify=c["verify"], host_workers=c["host_workers"],
            resume=False, device=self.device)

    def warm(self, items) -> None:
        warm_out = os.path.join(self.out, "warm")
        self._pool([self._path(it) for it in items], warm_out)
        for f in os.listdir(warm_out):
            os.remove(os.path.join(warm_out, f))

    def run(self, stream, seconds: float, span) -> list[Record]:
        list_len = int(stream.traffic.get("list_len", len(stream.items)))
        recs = []
        t0 = time.time()
        while time.time() - t0 < seconds:
            items = stream.take(list_len)
            paths = [self._path(it) for it in items]
            s = time.time()
            with span("corpus_compress list"):
                rep = self._pool(paths, self.out)
            e = time.time()
            secs = {os.path.basename(p): v for p, _, _, v in rep.per_file}
            self.calls.append((e - s, self.config["host_workers"], list(secs.values())))
            for it, p in zip(items, paths):
                out = os.path.join(self.out, os.path.basename(p) + ".atrc")
                done = os.path.basename(out) in secs and os.path.exists(out)
                end = os.stat(out).st_mtime - t0 if done else e - t0
                recs.append(Record(it.name, len(it.data),
                                   end - secs[os.path.basename(out)] if done else s - t0,
                                   end, done, None, {}, out if done else None))
        return recs

    def collect(self, records) -> None:
        """Reads each written container back for the check."""
        for r in records:
            if r.path is not None:
                with open(r.path, "rb") as f:
                    r.output = f.read()
