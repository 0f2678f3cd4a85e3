/* The port's own copy of native/recordio.h (mxnet_tpu_torch/_native.py builds it). */
/* RecordIO — dmlc-core wire-format compatible record container.
 *
 * The framework's record storage layer (reference behavior:
 * dmlc-core recordio; usage sites src/io/iter_image_recordio_2.cc,
 * python/mxnet/recordio.py MXRecordIO/MXIndexedRecordIO).
 *
 * Wire format (dmlc recordio spec):
 *   each part: [kMagic:4][lrec:4][payload][pad to 4B]
 *   lrec = cflag << 29 | length      (cflag: 0 whole, 1 begin, 2 mid, 3 end)
 *   records whose payload contains kMagic are split at those points so a
 *   corrupted stream can resynchronise on the magic word.
 *
 * Exposed as a flat C ABI for ctypes (the framework's C-ABI layer, ref:
 * include/mxnet/c_api.h MXRecordIO* functions).
 */
#ifndef MXTPU_RECORDIO_H_
#define MXTPU_RECORDIO_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void *RecordIOHandle;

/* writer */
int MXTPURecordIOWriterCreate(const char *path, RecordIOHandle *out);
int MXTPURecordIOWriterWrite(RecordIOHandle handle, const char *buf,
                             size_t size);
/* byte offset where the NEXT record will start (for .idx files) */
int MXTPURecordIOWriterTell(RecordIOHandle handle, size_t *pos);
int MXTPURecordIOWriterFree(RecordIOHandle handle);

/* reader */
int MXTPURecordIOReaderCreate(const char *path, RecordIOHandle *out);
/* returns 1 when a record was read (size may be 0 for an empty record),
 * 0 at EOF, -1 on a corrupt stream */
int MXTPURecordIOReaderRead(RecordIOHandle handle, const char **buf,
                            size_t *size);
int MXTPURecordIOReaderSeek(RecordIOHandle handle, size_t pos);
int MXTPURecordIOReaderTell(RecordIOHandle handle, size_t *pos);
int MXTPURecordIOReaderFree(RecordIOHandle handle);

const char *MXTPURecordIOGetLastError(void);

#ifdef __cplusplus
}
#endif

#endif /* MXTPU_RECORDIO_H_ */
