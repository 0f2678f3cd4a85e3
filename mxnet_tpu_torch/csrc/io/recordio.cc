/* The port's own copy of native/recordio.cc (mxnet_tpu_torch/_native.py builds it). */
/* RecordIO implementation — see recordio.h for the wire-format contract. */
#include "recordio.h"

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

thread_local std::string g_last_error;

int Fail(const std::string &msg) {
  g_last_error = msg;
  return -1;
}

inline uint32_t EncodeLRec(uint32_t cflag, uint32_t length) {
  return (cflag << 29u) | (length & ((1u << 29u) - 1u));
}
inline uint32_t DecodeFlag(uint32_t lrec) { return (lrec >> 29u) & 7u; }
inline uint32_t DecodeLength(uint32_t lrec) {
  return lrec & ((1u << 29u) - 1u);
}

struct Writer {
  FILE *fp = nullptr;
  size_t pos = 0;  // bytes written so far

  ~Writer() {
    if (fp) fclose(fp);
  }

  bool WriteAll(const void *buf, size_t n) {
    if (fwrite(buf, 1, n, fp) != n) return false;
    pos += n;
    return true;
  }

  // write one logical record, splitting payload at interior magic words
  bool WriteRecord(const char *data, size_t size) {
    // find split points: offsets of magic occurrences (4-byte aligned scan
    // is not required by the spec — dmlc scans every offset)
    std::vector<size_t> splits;
    if (size >= 4) {
      for (size_t i = 0; i + 4 <= size; ++i) {
        uint32_t v;
        memcpy(&v, data + i, 4);
        if (v == kMagic) {
          splits.push_back(i);
          i += 3;
        }
      }
    }
    size_t npart = splits.size() + 1;
    // validate every chunk length up front: refusing mid-record would leave
    // a dangling multi-part record that corrupts the stream for readers
    {
      size_t begin = 0;
      for (size_t p = 0; p < npart; ++p) {
        size_t end = (p < splits.size()) ? splits[p] : size;
        if (end - begin >= (size_t(1) << 29)) return false;
        begin = end;
      }
    }
    size_t begin = 0;
    for (size_t p = 0; p < npart; ++p) {
      size_t end = (p < splits.size()) ? splits[p] : size;
      uint32_t cflag;
      if (npart == 1) {
        cflag = 0;
      } else if (p == 0) {
        cflag = 1;
      } else if (p + 1 == npart) {
        cflag = 3;
      } else {
        cflag = 2;
      }
      if (end - begin >= (size_t(1) << 29)) {
        // LRec packs the length into 29 bits (dmlc-core recordio framing);
        // refuse instead of silently truncating the stream
        return false;
      }
      uint32_t len = static_cast<uint32_t>(end - begin);
      uint32_t lrec = EncodeLRec(cflag, len);
      if (!WriteAll(&kMagic, 4)) return false;
      if (!WriteAll(&lrec, 4)) return false;
      if (len && !WriteAll(data + begin, len)) return false;
      static const char zeros[4] = {0, 0, 0, 0};
      size_t padded = (len + 3u) & ~size_t(3);
      if (padded != len && !WriteAll(zeros, padded - len)) return false;
      // the magic word that triggered the split is consumed by the framing
      begin = end + ((p < splits.size()) ? 4 : 0);
    }
    return true;
  }
};

struct Reader {
  FILE *fp = nullptr;
  size_t pos = 0;
  std::string record;  // last assembled record

  ~Reader() {
    if (fp) fclose(fp);
  }

  bool ReadAll(void *buf, size_t n) {
    if (fread(buf, 1, n, fp) != n) return false;
    pos += n;
    return true;
  }

  // returns 1 on record, 0 on EOF, -1 on corrupt stream
  int NextRecord() {
    record.clear();
    bool in_multi = false;
    for (;;) {
      uint32_t magic;
      size_t got = fread(&magic, 1, 4, fp);
      if (got == 0) return in_multi ? -1 : 0;  // clean EOF only between records
      if (got != 4) return -1;
      pos += 4;
      if (magic != kMagic) return -1;
      uint32_t lrec;
      if (!ReadAll(&lrec, 4)) return -1;
      uint32_t cflag = DecodeFlag(lrec);
      uint32_t len = DecodeLength(lrec);
      size_t old = record.size();
      if (in_multi) {
        // interior magic word was consumed by the framing: restore it
        record.append(reinterpret_cast<const char *>(&kMagic), 4);
        old = record.size();
      }
      record.resize(old + len);
      if (len && !ReadAll(&record[old], len)) return -1;
      size_t padded = (len + 3u) & ~size_t(3);
      if (padded != len) {
        char pad[4];
        if (!ReadAll(pad, padded - len)) return -1;
      }
      if (cflag == 0) {
        if (in_multi) return -1;
        return 1;
      }
      if (cflag == 1) {
        if (in_multi) return -1;
        in_multi = true;
      } else if (cflag == 2) {
        if (!in_multi) return -1;
      } else if (cflag == 3) {
        if (!in_multi) return -1;
        return 1;
      }
    }
  }
};

}  // namespace

extern "C" {

const char *MXTPURecordIOGetLastError(void) { return g_last_error.c_str(); }

int MXTPURecordIOWriterCreate(const char *path, RecordIOHandle *out) {
  auto *w = new Writer();
  w->fp = fopen(path, "wb");
  if (!w->fp) {
    delete w;
    return Fail(std::string("cannot open for write: ") + path);
  }
  *out = w;
  return 0;
}

int MXTPURecordIOWriterWrite(RecordIOHandle handle, const char *buf,
                             size_t size) {
  auto *w = static_cast<Writer *>(handle);
  if (!w->WriteRecord(buf, size)) return Fail("write failed");
  return 0;
}

int MXTPURecordIOWriterTell(RecordIOHandle handle, size_t *pos) {
  *pos = static_cast<Writer *>(handle)->pos;
  return 0;
}

int MXTPURecordIOWriterFree(RecordIOHandle handle) {
  delete static_cast<Writer *>(handle);
  return 0;
}

int MXTPURecordIOReaderCreate(const char *path, RecordIOHandle *out) {
  auto *r = new Reader();
  r->fp = fopen(path, "rb");
  if (!r->fp) {
    delete r;
    return Fail(std::string("cannot open for read: ") + path);
  }
  *out = r;
  return 0;
}

/* returns 1 when a record was read (size may be 0 for an empty record),
 * 0 at EOF, -1 on a corrupt stream */
int MXTPURecordIOReaderRead(RecordIOHandle handle, const char **buf,
                            size_t *size) {
  auto *r = static_cast<Reader *>(handle);
  int rc = r->NextRecord();
  if (rc < 0) return Fail("corrupt recordio stream");
  if (rc == 0) {
    *buf = nullptr;
    *size = 0;
    return 0;
  }
  *buf = r->record.data();
  *size = r->record.size();
  return 1;
}

int MXTPURecordIOReaderSeek(RecordIOHandle handle, size_t pos) {
  auto *r = static_cast<Reader *>(handle);
  if (fseek(r->fp, static_cast<long>(pos), SEEK_SET) != 0)
    return Fail("seek failed");
  r->pos = pos;
  return 0;
}

int MXTPURecordIOReaderTell(RecordIOHandle handle, size_t *pos) {
  *pos = static_cast<Reader *>(handle)->pos;
  return 0;
}

int MXTPURecordIOReaderFree(RecordIOHandle handle) {
  delete static_cast<Reader *>(handle);
  return 0;
}

}  // extern "C"
