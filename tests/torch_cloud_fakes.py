"""In-memory fakes of the google-cloud-storage and boto3 S3 clients, for
the cloud plugins of both packages. They speak the services' range
dialects (both ends inclusive) and raise not-found errors shaped as the
real clients' are (a 404 ``code`` beside an ``errors`` attribute; a
botocore-style ``response``). No network, no SDK."""

import io
from types import SimpleNamespace


class FakeNotFound(Exception):
    """Shaped like google.api_core.exceptions.NotFound."""

    code = 404
    errors = ()


class FakeNoSuchKey(Exception):
    """Shaped like botocore's ClientError for a missing key."""

    def __init__(self, key):
        super().__init__(f"NoSuchKey: {key}")
        self.response = {"Error": {"Code": "NoSuchKey"}, "ResponseMetadata": {"HTTPStatusCode": 404}}


class FakeBlob:
    def __init__(self, store, key, hooks):
        self._store = store
        self._key = key
        self._hooks = hooks
        self.size = None
        self.updated = None

    def upload_from_file(self, fileobj):
        hook = self._hooks.get("on_upload")
        if hook is not None:
            hook(self._key)
        self._store[self._key] = fileobj.read()

    def download_as_bytes(self, start=None, end=None):
        if self._key not in self._store:
            raise FakeNotFound(f"404 GET {self._key}")
        data = self._store[self._key]
        if start is None:
            return data
        return data[start:end + 1]  # GCS's end is inclusive

    def compose(self, sources):
        assert len(sources) <= 32, "GCS composes at most 32 components"
        hook = self._hooks.get("on_compose")
        if hook is not None:
            hook(self._key)
        self._store[self._key] = b"".join(self._store[s._key] for s in sources)

    def reload(self):
        if self._key not in self._store:
            raise FakeNotFound(f"404 HEAD {self._key}")
        self.size = len(self._store[self._key])

    def delete(self):
        if self._key not in self._store:
            raise FakeNotFound(f"404 DELETE {self._key}")
        del self._store[self._key]


class FakeGCSBucket:
    def __init__(self, store, hooks):
        self._store = store
        self._hooks = hooks

    def blob(self, key):
        return FakeBlob(self._store, key, self._hooks)


class FakeGCSClient:
    """``store`` maps object names to bytes; ``hooks`` (``on_upload``,
    ``on_compose``) are called with the object name before the op."""

    def __init__(self):
        self.store = {}
        self.hooks = {}

    def bucket(self, name):
        return FakeGCSBucket(self.store, self.hooks)

    def list_blobs(self, bucket_name, prefix=""):
        return [SimpleNamespace(name=k) for k in sorted(self.store) if k.startswith(prefix)]


class FakeS3Client:
    """``store`` maps (bucket, key) to bytes."""

    def __init__(self):
        self.store = {}

    def put_object(self, Bucket, Key, Body):
        self.store[(Bucket, Key)] = bytes(Body)

    def get_object(self, Bucket, Key, Range=None):
        if (Bucket, Key) not in self.store:
            raise FakeNoSuchKey(Key)
        data = self.store[(Bucket, Key)]
        if Range is not None:
            start, end = Range.split("=", 1)[1].split("-")
            data = data[int(start):int(end) + 1]  # HTTP range ends are inclusive
        return {"Body": io.BytesIO(data)}

    def head_object(self, Bucket, Key):
        if (Bucket, Key) not in self.store:
            raise FakeNoSuchKey(Key)
        return {"ContentLength": len(self.store[(Bucket, Key)])}

    def delete_object(self, Bucket, Key):
        if (Bucket, Key) not in self.store:
            raise FakeNoSuchKey(Key)
        del self.store[(Bucket, Key)]

    def get_paginator(self, op):
        assert op == "list_objects_v2"
        store = self.store

        class _Paginator:
            def paginate(self, Bucket, Prefix=""):
                yield {"Contents": [{"Key": k} for (b, k) in sorted(store)
                                    if b == Bucket and k.startswith(Prefix)]}

        return _Paginator()


def _inject(monkeypatch, module, name, client):
    base = getattr(module, name)

    class Injected(base):
        def __init__(self, root, client_=None):
            base.__init__(self, root, client=client)

    monkeypatch.setattr(module, name, Injected)


def route_to_fakes(monkeypatch, gcs=None, s3=None):
    """Make ``gs://`` (``s3://``) URLs of both packages open their plugins
    over the fake client given, through the packages' own routing."""
    from torchsnapshot_tpu.storage_plugins import gcs as jgcs
    from torchsnapshot_tpu.storage_plugins import s3 as js3
    from torchsnapshot_tpu_torch.storage_plugins import gcs as tgcs
    from torchsnapshot_tpu_torch.storage_plugins import s3 as ts3

    if gcs is not None:
        for module in (jgcs, tgcs):
            _inject(monkeypatch, module, "GCSStoragePlugin", gcs)
    if s3 is not None:
        for module in (js3, ts3):
            _inject(monkeypatch, module, "S3StoragePlugin", s3)
