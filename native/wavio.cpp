// Native audio IO for the Conformer ASR framework.
//
// The reference delegates audio decode to torchaudio/librosa C++ binaries
// (SURVEY.md §2: no first-party native code anywhere).  This module is the
// framework's own native layer: a multithreaded WAV decoder that fills
// caller-provided float32 batch buffers directly — no per-file Python
// object churn, no GIL during decode — feeding the host→device pipeline at
// memory-bandwidth speed.
//
// Exposed via the CPython C API (no pybind11 in this environment):
//   wavio.decode_batch(paths: list[str], out: ndarray (B, S) f32,
//                      lengths: ndarray (B,) int32, num_threads=...) -> None
//   wavio.probe(path: str) -> (num_samples: int, sample_rate: int)
//
// Supported: PCM16 / PCM32 / PCM8 / float32 WAV, mono or averaged multi-
// channel.  Python fallback lives in data/audio.py (stdlib `wave`).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;
  uint32_t data_bytes = 0;
};

bool parse_header(FILE* f, WavInfo* info, std::string* err) {
  char tag[4];
  uint32_t chunk_size = 0;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0) {
    *err = "not a RIFF file";
    return false;
  }
  fseek(f, 4, SEEK_CUR);  // total size
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0) {
    *err = "not a WAVE file";
    return false;
  }
  bool have_fmt = false;
  while (fread(tag, 1, 4, f) == 4 && fread(&chunk_size, 4, 1, f) == 1) {
    if (memcmp(tag, "fmt ", 4) == 0) {
      uint8_t buf[16];
      if (chunk_size < 16 || fread(buf, 1, 16, f) != 16) {
        *err = "bad fmt chunk";
        return false;
      }
      memcpy(&info->format, buf, 2);
      memcpy(&info->channels, buf + 2, 2);
      memcpy(&info->sample_rate, buf + 4, 4);
      memcpy(&info->bits, buf + 14, 2);
      if (chunk_size > 16) fseek(f, chunk_size - 16, SEEK_CUR);
      have_fmt = true;
    } else if (memcmp(tag, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = chunk_size;
      if (!have_fmt) {
        *err = "data before fmt";
        return false;
      }
      return true;
    } else {
      fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
  }
  *err = "no data chunk";
  return false;
}

// Decode one file into out[0:capacity]; returns decoded sample count
// (mono frames), or -1 with *err set.
long decode_file(const char* path, float* out, long capacity, std::string* err) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    *err = std::string("cannot open ") + path;
    return -1;
  }
  WavInfo info;
  if (!parse_header(f, &info, err)) {
    fclose(f);
    *err += std::string(" (") + path + ")";
    return -1;
  }
  const int ch = info.channels ? info.channels : 1;
  const int bytes_per = info.bits / 8;
  const long frames_in_file = info.data_bytes / (bytes_per * ch);
  const long frames = frames_in_file < capacity ? frames_in_file : capacity;

  std::vector<uint8_t> raw(static_cast<size_t>(frames) * bytes_per * ch);
  fseek(f, info.data_offset, SEEK_SET);
  size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  const long got_frames = static_cast<long>(got / (bytes_per * ch));

  const float inv16 = 1.0f / 32768.0f;
  const float inv32 = 1.0f / 2147483648.0f;
  for (long i = 0; i < got_frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < ch; ++c) {
      const uint8_t* p = raw.data() + (static_cast<size_t>(i) * ch + c) * bytes_per;
      float v = 0.0f;
      if (info.format == 3 && info.bits == 32) {
        float fv;
        memcpy(&fv, p, 4);
        v = fv;
      } else if (info.bits == 16) {
        int16_t s;
        memcpy(&s, p, 2);
        v = s * inv16;
      } else if (info.bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = s * inv32;
      } else if (info.bits == 8) {
        v = (static_cast<int>(p[0]) - 128) / 128.0f;
      }
      acc += v;
    }
    out[i] = acc / ch;
  }
  return got_frames;
}

PyObject* py_decode_batch(PyObject*, PyObject* args, PyObject* kwargs) {
  PyObject* paths_obj;
  PyObject* out_obj;
  PyObject* len_obj;
  int num_threads = 8;
  static const char* kwlist[] = {"paths", "out", "lengths", "num_threads", nullptr};
  if (!PyArg_ParseTupleAndKeywords(
          args, kwargs, "OOO|i", const_cast<char**>(kwlist), &paths_obj,
          &out_obj, &len_obj, &num_threads)) {
    return nullptr;
  }
  // full ND buffer requests so shape/contiguity are visible
  Py_buffer out_buf, len_buf;
  if (PyObject_GetBuffer(out_obj, &out_buf,
                         PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE | PyBUF_FORMAT) < 0) {
    return nullptr;
  }
  if (PyObject_GetBuffer(len_obj, &len_buf,
                         PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE | PyBUF_FORMAT) < 0) {
    PyBuffer_Release(&out_buf);
    return nullptr;
  }
  PyObject* seq = PySequence_Fast(paths_obj, "paths must be a sequence");
  if (!seq) {
    PyBuffer_Release(&out_buf);
    PyBuffer_Release(&len_buf);
    return nullptr;
  }
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

  // out: (B, S) float32 C-contiguous; lengths: (B,) int32
  if (out_buf.ndim != 2 || out_buf.itemsize != 4 ||
      len_buf.ndim != 1 || len_buf.itemsize != 4 ||
      out_buf.shape[0] < n || len_buf.shape[0] < n) {
    Py_DECREF(seq);
    PyBuffer_Release(&out_buf);
    PyBuffer_Release(&len_buf);
    PyErr_SetString(PyExc_ValueError,
                    "out must be (B,S) float32, lengths (B,) int32, B >= len(paths)");
    return nullptr;
  }
  const long capacity = static_cast<long>(out_buf.shape[1]);
  float* out = static_cast<float*>(out_buf.buf);
  int32_t* lengths = static_cast<int32_t*>(len_buf.buf);

  std::vector<std::string> paths;
  paths.reserve(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    const char* s = PyUnicode_AsUTF8(item);
    if (!s) {
      Py_DECREF(seq);
      PyBuffer_Release(&out_buf);
      PyBuffer_Release(&len_buf);
      return nullptr;
    }
    paths.emplace_back(s);
  }
  Py_DECREF(seq);

  std::atomic<long> next{0};
  std::atomic<bool> failed{false};
  std::string first_err;
  std::mutex err_mu;

  auto worker = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n || failed.load()) break;
      std::string err;
      long got = decode_file(paths[i].c_str(), out + i * capacity, capacity, &err);
      if (got < 0) {
        std::lock_guard<std::mutex> lk(err_mu);
        if (!failed.exchange(true)) first_err = err;
        break;
      }
      // zero the tail
      memset(out + i * capacity + got, 0, (capacity - got) * sizeof(float));
      lengths[i] = static_cast<int32_t>(got);
    }
  };

  int nt = num_threads < 1 ? 1 : num_threads;
  if (nt > n) nt = static_cast<int>(n ? n : 1);
  Py_BEGIN_ALLOW_THREADS
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&out_buf);
  PyBuffer_Release(&len_buf);
  if (failed.load()) {
    PyErr_SetString(PyExc_IOError, first_err.c_str());
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* py_probe(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) {
    PyErr_SetString(PyExc_IOError, "cannot open file");
    return nullptr;
  }
  WavInfo info;
  std::string err;
  if (!parse_header(f, &info, &err)) {
    fclose(f);
    PyErr_SetString(PyExc_IOError, err.c_str());
    return nullptr;
  }
  fclose(f);
  const int ch = info.channels ? info.channels : 1;
  long frames = info.data_bytes / ((info.bits / 8) * ch);
  return Py_BuildValue("(lI)", frames, info.sample_rate);
}

PyMethodDef methods[] = {
    {"decode_batch", reinterpret_cast<PyCFunction>(py_decode_batch),
     METH_VARARGS | METH_KEYWORDS,
     "decode_batch(paths, out, lengths, num_threads=8): multithreaded WAV "
     "decode into a preallocated (B, S) float32 buffer"},
    {"probe", py_probe, METH_VARARGS, "probe(path) -> (num_samples, sample_rate)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "wavio",
                      "native multithreaded WAV decoding", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_wavio(void) { return PyModule_Create(&module); }
